// Post-attention half of a post-LN BERT layer in one kernel:
//   out = LN2(x2 + (gelu(x2 @ W1 + b1) @ W2 + b2)),  x2 = LN1(x + attn_out)
//
// Replaces the TPU kernel _ffn_ln_kernel (stonkgs_tpu/ops/fused_ffn.py:438).
// Bound on the H100 by operations (4*M*768*I); see
// stonkgs_tpu_torch/ops/fused_ffn.py for the design note.
//
// One block owns BM rows (48 for bf16, 16 for fp32) and 384 threads:
//   1. LN1 of its rows into shared memory (x2, rounded to T);
//   2. for each 192-wide chunk of the intermediate axis:
//        h = x2 @ W1[:, chunk]    (W1 streamed in 64 x 192 tiles)
//        h = round_T(gelu(h + b1))
//        acc += h @ W2[chunk, :]  (W2 streamed in 16 x 768 tiles)
//      with the (BM, 768) fp32 accumulator held in registers;
//   3. epilogue per 16 rows: ff = round_T(acc + b2), LN2(x2 + ff) -> out.
// The weight tiles of all chunks form one stream through a ring of
// STAGES shared-memory buffers filled by cp.async, STAGES - 1 tiles ahead
// of the tile in use, with one block barrier per tile.  bf16 products use
// the tensor cores through nvcuda::wmma (16x16x16, fp32 accumulation);
// fp32 products are plain FMAs.
//
// C interface (all pointers on the device; LayerNorm and bias vectors fp32):
//   int ffn_ln_block(int dtype /*0 fp32, 1 bf16*/, x, attn_out, ln1_scale,
//                    ln1_bias, w1 (768, I), b1, w2 (I, 768), b2, ln2_scale,
//                    ln2_bias, out, int M, int I, int act /*0 gelu(erf),
//                    1 gelu_new(tanh)*/, float eps, cudaStream_t stream)
// with I a multiple of 192; returns cudaGetLastError() after the launch.

#include <mma.h>

#include "common.cuh"

namespace stonkgs {
namespace {

using namespace nvcuda;

constexpr int kH = 768;      // hidden width
constexpr int kChunk = 192;  // intermediate-axis chunk
constexpr int kK1 = 64;      // rows (hidden axis) of a W1 tile
constexpr int kK2 = 16;      // rows (intermediate axis) of a W2 tile
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kH / 32;                 // row values per lane in the LayerNorms
constexpr int kTiles1 = kH / kK1;             // W1 tiles per chunk
constexpr int kTiles = kTiles1 + kChunk / kK2;  // W1 then W2 tiles per chunk

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BM = 48;     // rows per block
  static constexpr int PAD = 8;     // row padding (elements) against bank conflicts
  static constexpr int STAGES = 3;  // weight-tile ring
};
template <> struct Tile<float> {
  static constexpr int BM = 16;
  static constexpr int PAD = 4;
  static constexpr int STAGES = 2;
};

template <typename T> struct Layout {
  static constexpr int BM = Tile<T>::BM, PAD = Tile<T>::PAD, STAGES = Tile<T>::STAGES;
  static constexpr int XS = kH + PAD;       // x2 row stride (T)
  static constexpr int W1S = kChunk + PAD;  // W1 tile row stride (T)
  static constexpr int W2S = kH + PAD;      // W2 tile row stride (T)
  static constexpr int WBUF = kK1 * W1S > kK2 * W2S ? kK1 * W1S : kK2 * W2S;
  static constexpr int HFS = kChunk + 4;    // fp32 h chunk row stride
  static constexpr int HSS = kChunk + PAD;  // rounded h chunk row stride (T)
  static constexpr int STS = kH + 4;        // fp32 epilogue staging row stride
  static constexpr size_t xs_bytes = align128(size_t(BM) * XS * sizeof(T));
  static constexpr size_t wbuf_bytes = align128(size_t(STAGES) * WBUF * sizeof(T));
  static constexpr size_t hf_bytes = align128(size_t(BM) * HFS * sizeof(float));
  static constexpr size_t hs_bytes = align128(size_t(BM) * HSS * sizeof(T));
  static constexpr size_t work_bytes = wbuf_bytes + hf_bytes + hs_bytes;
  static constexpr size_t stage_bytes = size_t(16) * STS * sizeof(float);
  static constexpr size_t smem_bytes =
      xs_bytes + (work_bytes > stage_bytes ? work_bytes : stage_bytes);
};

__device__ __forceinline__ float gelu(float h, int act) {
  if (act == 0) return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
  const float c = 0.79788456080286536f;  // sqrt(2 / pi)
  return 0.5f * h * (1.0f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// rows x cols elements of T, global (row stride gs) -> shared (row stride ss),
// in 16-byte cp.async pieces spread over the block
template <typename T>
__device__ __forceinline__ void load_tile_async(T* s, int ss, const T* g, size_t gs,
                                                int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * V;
    cp_async16(s + r * ss + c, g + r * gs + c);
  }
}

// Tile g of the weight stream (chunk g / kTiles; W1 tiles, then W2 tiles)
// into ring buffer g % STAGES; one cp.async group per call, empty past the end.
template <typename T>
__device__ __forceinline__ void fetch_tile(T* wbuf, const T* w1, const T* w2, int I, int g,
                                           int total) {
  using L = Layout<T>;
  if (g < total) {
    T* dst = wbuf + (g % L::STAGES) * L::WBUF;
    const int c0 = (g / kTiles) * kChunk, t = g % kTiles;
    if (t < kTiles1)
      load_tile_async(dst, L::W1S, w1 + size_t(t) * kK1 * I + c0, size_t(I), kK1, kChunk);
    else
      load_tile_async(dst, L::W2S, w2 + size_t(c0 + (t - kTiles1) * kK2) * kH, size_t(kH),
                      kK2, kH);
  }
  cp_async_commit();
}

// LayerNorm of one row held as kPer values per lane (column lane + 32*i)
__device__ __forceinline__ void layer_norm_row(float (&v)[kPer], const float* g,
                                               const float* b, float eps, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s += v[i];
  const float mean = warp_sum(s) / kH;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / kH + eps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = (v[i] - mean) * rstd * g[c] + b[c];
  }
}

// Epilogue for 16 rows [r0, r0+16) of the block, whose W2 product sits in
// `stage` (fp32, 16 x STS): ff = round(acc + b2); out = LN2(x2 + ff).
template <typename T>
__device__ __forceinline__ void epilogue_rows(const float* stage, const T* xs, int r0,
                                              int row0, int M, const float* b2,
                                              const float* g2, const float* be2,
                                              float eps, T* out) {
  using L = Layout<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 16; r += kWarps) {
    const int gr = row0 + r0 + r;
    if (gr >= M) continue;
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      const float ff = round_to<T>(stage[r * L::STS + c] + b2[c]);
      v[i] = to_f(xs[(r0 + r) * L::XS + c]) + ff;
    }
    layer_norm_row(v, g2, be2, eps, lane);
    T* o = out + size_t(gr) * kH;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[lane + 32 * i] = from_f<T>(v[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const float* __restrict__ g1, const float* __restrict__ be1,
              const T* __restrict__ w1, const float* __restrict__ b1,
              const T* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ g2, const float* __restrict__ be2,
              T* __restrict__ out, int M, int I, int act, float eps) {
  using L = Layout<T>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  unsigned char* work = smem + L::xs_bytes;
  T* wbuf = reinterpret_cast<T*>(work);
  float* hf = reinterpret_cast<float*>(work + L::wbuf_bytes);
  T* hs = reinterpret_cast<T*>(work + L::wbuf_bytes + L::hf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  const int total = (I / kChunk) * kTiles;  // weight tiles in the stream

  // the first tiles fly while LN1 runs
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) fetch_tile(wbuf, w1, w2, I, g, total);

  // 1. x2 = LN1(x + attn_out), statistics in fp32, rounded to T
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
    layer_norm_row(v, g1, be1, eps, lane);
#pragma unroll
    for (int i = 0; i < kPer; ++i) xr[lane + 32 * i] = from_f<T>(v[i]);
  }

  // next tile of the weight stream: wait for it, then refill the buffer
  // that the previous tile used (the barrier makes it free)
  int g = 0;
  auto advance = [&]() -> const T* {
    cp_async_wait<STAGES - 2>();  // tile g is in (this thread's pieces)
    __syncthreads();              // ... everyone's; buffer (g-1) % STAGES is free
    fetch_tile(wbuf, w1, w2, I, g + STAGES - 1, total);
    const T* cur = wbuf + (g % STAGES) * L::WBUF;
    ++g;
    return cur;
  };

  if constexpr (kIsBf16<T>) {
    // W1 product: warp owns h columns [warp*16, +16) of the chunk, all rows.
    // W2 product: warp owns output columns [warp*64, +64), all rows.
    constexpr int RF = BM / 16;         // row fragments
    constexpr int kCols = kH / kWarps;  // 64
    using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    static_assert(kChunk / 16 == kWarps, "one h column fragment per warp");
    Acc acc[RF][kCols / 16];
#pragma unroll
    for (int i = 0; i < RF; ++i) {
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    }
    for (int c0 = 0; c0 < I; c0 += kChunk) {
      // 2a. h = x2 @ W1[:, chunk]
      Acc hacc[RF];
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::fill_fragment(hacc[i], 0.f);
      for (int t = 0; t < kTiles1; ++t) {
        const T* cur = advance();
#pragma unroll
        for (int kk = 0; kk < kK1; kk += 16) {
          FragB bf;
          wmma::load_matrix_sync(bf, cur + kk * L::W1S + warp * 16, L::W1S);
#pragma unroll
          for (int i = 0; i < RF; ++i) {
            FragA af;
            wmma::load_matrix_sync(af, xs + i * 16 * L::XS + t * kK1 + kk, L::XS);
            wmma::mma_sync(hacc[i], af, bf, hacc[i]);
          }
        }
      }
      // 2b. h = round(gelu(h + b1)) on the warp's own strip; the barrier in
      // the next advance() publishes hs to every warp
#pragma unroll
      for (int i = 0; i < RF; ++i)
        wmma::store_matrix_sync(hf + i * 16 * L::HFS + warp * 16, hacc[i], L::HFS,
                                wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < BM * 16; e += 32) {
        const int r = e / 16, c = warp * 16 + e % 16;
        hs[r * L::HSS + c] = from_f<T>(gelu(hf[r * L::HFS + c] + b1[c0 + c], act));
      }
      // 2c. acc += h @ W2[chunk, :]
      for (int kt = 0; kt < kChunk / kK2; ++kt) {
        const T* cur = advance();
        FragA af[RF];
#pragma unroll
        for (int i = 0; i < RF; ++i)
          wmma::load_matrix_sync(af[i], hs + i * 16 * L::HSS + kt * kK2, L::HSS);
#pragma unroll
        for (int j = 0; j < kCols / 16; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, cur + warp * kCols + j * 16, L::W2S);
#pragma unroll
          for (int i = 0; i < RF; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the ring is free: stage the accumulators there
    // 3. epilogue, 16 rows at a time
#pragma unroll
    for (int i = 0; i < RF; ++i) {
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j)
        wmma::store_matrix_sync(stage + warp * kCols + j * 16, acc[i][j], L::STS,
                                wmma::mem_row_major);
      __syncthreads();
      epilogue_rows<T>(stage, xs, i * 16, row0, M, b2, g2, be2, eps, out);
      __syncthreads();
    }
  } else {
    // fp32: plain FMAs.  W1 product: thread owns h column tid % 192 and rows
    // [(tid / 192) * 8, +8); W2 product: columns tid and tid + 384, all rows.
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
      for (int t = 0; t < kTiles1; ++t) {
        const T* cur = advance();
        for (int kk = 0; kk < kK1; ++kk) {
          const float w = cur[kk * L::W1S + hc];
#pragma unroll
          for (int r = 0; r < 8; ++r) hacc[r] += xs[(hr + r) * L::XS + t * kK1 + kk] * w;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        hs[(hr + r) * L::HSS + hc] = from_f<T>(gelu(hacc[r] + b1[c0 + hc], act));
      for (int kt = 0; kt < kChunk / kK2; ++kt) {
        const T* cur = advance();
        for (int kk = 0; kk < kK2; ++kk) {
          const float wa = cur[kk * L::W2S + tid], wb = cur[kk * L::W2S + tid + kThreads];
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float h = hs[r * L::HSS + kt * kK2 + kk];
            acc[r][0] += h * wa;
            acc[r][1] += h * wb;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      stage[r * L::STS + tid] = acc[r][0];
      stage[r * L::STS + tid + kThreads] = acc[r][1];
    }
    __syncthreads();
    epilogue_rows<T>(stage, xs, 0, row0, M, b2, g2, be2, eps, out);
    (void)hf;
  }
}

template <typename T>
int launch(const void* x, const void* a, const float* g1, const float* be1, const void* w1,
           const float* b1, const void* w2, const float* b2, const float* g2,
           const float* be2, void* out, int M, int I, int act, float eps,
           cudaStream_t stream) {
  using L = Layout<T>;
  if (M <= 0 || I <= 0 || I % kChunk != 0 || (act != 0 && act != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ffn_ln_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L::smem_bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((M + L::BM - 1) / L::BM);
  ffn_ln_kernel<T><<<grid, kThreads, L::smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), g1, be1,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, g2, be2,
      static_cast<T*>(out), M, I, act, eps);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace stonkgs

extern "C" int ffn_ln_block(int dtype, const void* x, const void* attn_out,
                            const float* ln1_scale, const float* ln1_bias, const void* w1,
                            const float* b1, const void* w2, const float* b2,
                            const float* ln2_scale, const float* ln2_bias, void* out, int M,
                            int I, int act, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stonkgs::launch<float>(x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
                                  ln2_scale, ln2_bias, out, M, I, act, eps, s);
  if (dtype == 1)
    return stonkgs::launch<__nv_bfloat16>(x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2,
                                          ln2_scale, ln2_bias, out, M, I, act, eps, s);
  return int(cudaErrorInvalidValue);
}
