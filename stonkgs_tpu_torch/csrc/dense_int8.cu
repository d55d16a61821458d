// Fused int8 dense: per-row absmax quantization of x, int8 x int8 -> int32
// on the tensor cores, and the epilogue acc * s_x * s_w + bias:
//   s_x[m] = max(max_k |x[m, k]| / 127, 1e-12)
//   q[m, k] = clip(rint(x[m, k] / s_x[m]), -127, 127)
//   y[m, n] = round_T(((float(sum_k q[m, k] * W[k, n]) * s_x[m]) * s_w[n]) + b[n])
//
// Replaces the TPU kernel _fused_kernel (stonkgs_tpu/ops/quantization_pallas.py:33).
// Bound on the H100 by bytes at the 768 -> 768 projections and by
// operations at the 768 <-> 3072 products (see
// stonkgs_tpu_torch/ops/quantization.py for the design note).
//
// One block of 8 warps owns a 128 x 128 tile of y:
//   1. the absmax of each of its rows over the whole K -> s_x in shared memory;
//   2. for each 64-deep step of K: the x tile (loaded into registers one
//      step ahead) quantized into an int8 shared tile, the int8 W tile
//      beside it, and 16 x 16 x 16 int8 wmma products into int32
//      accumulators (each warp a 64 x 32 sub-tile), two buffers in turn;
//   3. the epilogue per 16 x 16 fragment through a per-warp staging tile.
// Shared tiles are kept in 16-wide k-blocks (A as [k/16][m][16], B as
// [n/16][k][16]) so that every wmma fragment is 256 contiguous bytes.
// IEEE division and rintf (round half to even) give the codes of the
// plain version exactly; the epilogue's products are rounded one by one
// (no fused multiply-add), as the plain version computes them.
//
// C interface (all pointers on the device; x has rows of stride ldx
// elements and a unit column stride, 16-byte aligned rows; W (K, N)
// row-major int8; w_scale and bias fp32, bias may be null; out (M, N)
// contiguous in x's dtype):
//   int dense_int8(int dtype /*0 fp32, 1 bf16*/, x, long long ldx, w,
//                  w_scale, bias, out, int M, int K, int N,
//                  cudaStream_t stream)
// with M >= 1, N >= 1 and K a multiple of 16; returns cudaGetLastError()
// after the launch.

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace stonkgs {
namespace int8dense {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 64;   // block tile and K step
constexpr int kThreads = 256, kWarps = 8;
constexpr int WM = 64, WN = 32;              // warp tile: 2 x 4 warps
constexpr int FM = WM / 16, FN = WN / 16;    // 4 x 2 fragments a warp
constexpr int kUnitRows = 8;                 // rows of a 32-lane load unit

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// x tile of one K step as 16-byte vectors of V elements.  A 32-lane unit
// covers 8 rows and 32 / (8 P) k-blocks, P = 16 / V vectors per 16-wide
// k-block, so that a half warp stores one contiguous 128-byte run of codes
// and each row is read in whole 32-byte sectors.
template <typename T> struct XTile {
  static constexpr int V = 16 / sizeof(T);               // elements a vector
  static constexpr int P = 16 / V;                       // vectors a k-block row
  static constexpr int KU = 32 / (P * kUnitRows);        // k-blocks a unit
  static constexpr int kUnits = (BM / kUnitRows) * (BK / 16 / KU);
  static constexpr int kPer = kUnits * 32 / kThreads;    // vectors a thread
};

// W tile of one K step (BK x BN int8) as 16-byte vectors (one k row of
// one 16-wide n-block): a unit is 8 k rows x 4 n-blocks.
constexpr int kWUnits = (BK / kUnitRows) * (BN / 16 / 4);
constexpr int kWPer = kWUnits * 32 / kThreads;

// the int8 code of v at scale s, as the low byte of an unsigned
__device__ __forceinline__ unsigned quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// the codes of four consecutive values, little-endian in one word
__device__ __forceinline__ unsigned quant4(const float* f, float s) {
  return quant(f[0], s) | (quant(f[1], s) << 8) | (quant(f[2], s) << 16) | (quant(f[3], s) << 24);
}

__device__ __forceinline__ float absmax4(float m, const float4& f) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y))), fmaxf(fabsf(f.z), fabsf(f.w)));
}

// the V values of a 16-byte vector as floats
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(b[i]);
}

template <typename T, bool kVecW>
__global__ void __launch_bounds__(kThreads, kIsBf16<T> ? 2 : 1)
dense_int8_kernel(const T* __restrict__ x, long long ldx, const signed char* __restrict__ w,
                  const float* __restrict__ w_scale, const float* __restrict__ bias,
                  T* __restrict__ out, int M, int K, int N) {
  using XT = XTile<T>;
  __shared__ __align__(128) signed char As[2][BK / 16][BM][16];
  __shared__ __align__(128) signed char Bs[2][BN / 16][BK][16];
  __shared__ __align__(128) int stage[kWarps][16 * 16];
  __shared__ float sx[BM];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;

  // 1. row scales over the whole K
  for (int r = warp; r < BM; r += kWarps) {
    const int gr = m0 + r;
    float m = 0.f;
    if (gr < M) {
      const T* row = x + size_t(gr) * ldx;
      for (int k = lane * XT::V; k < K; k += 32 * XT::V) {
        float f[XT::V];
        unpack<T>(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
        for (int i = 0; i < XT::V; i += 4) m = absmax4(m, make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]));
      }
    }
    m = warp_max(m);
    if (lane == 0) sx[r] = fmaxf(m / 127.0f, 1e-12f);
  }
  __syncthreads();

  // coordinates of the loads of this thread
  auto x_coord = [&](int i, int& r, int& c) {
    const int v = i * kThreads + threadIdx.x, u = v / 32, l = v % 32;
    r = (u % (BM / kUnitRows)) * kUnitRows + (l / XT::P) % kUnitRows;
    const int kb = (u / (BM / kUnitRows)) * XT::KU + l / (XT::P * kUnitRows);
    c = kb * 16 + (l % XT::P) * XT::V;
  };
  auto w_coord = [&](int i, int& r, int& nb) {
    const int v = i * kThreads + threadIdx.x, u = v / 32, l = v % 32;
    r = (u % (BK / kUnitRows)) * kUnitRows + l % kUnitRows;
    nb = (u / (BK / kUnitRows)) * 4 + l / kUnitRows;
  };

  uint4 xr[XT::kPer], wr[kWPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XT::kPer; ++i) {
      int r, c;
      x_coord(i, r, c);
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * ldx + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      int r, nb;
      w_coord(i, r, nb);
      const int k = k0 + r, n = n0 + nb * 16;
      wr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k >= K) continue;
      const signed char* src = w + size_t(k) * N + n;
      if constexpr (kVecW) {
        if (n < N) wr[i] = *reinterpret_cast<const uint4*>(src);
      } else {   // byte by byte: W's rows are not 16-byte aligned
        unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N) word[j / 4] |= (static_cast<unsigned>(src[j]) & 0xffu) << (8 * (j % 4));
        wr[i] = make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < XT::kPer; ++i) {
      int r, c;
      x_coord(i, r, c);
      float f[XT::V];
      unpack<T>(xr[i], f);
      const float s = sx[r];
      signed char* dst = &As[buf][c / 16][r][c % 16];
      if constexpr (XT::V == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(quant4(f, s), quant4(f + 4, s));
      else
        *reinterpret_cast<unsigned*>(dst) = quant4(f, s);
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      int r, nb;
      w_coord(i, r, nb);
      *reinterpret_cast<uint4*>(&Bs[buf][nb][r][0]) = wr[i];
    }
  };

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);
  }

  // 2. the K loop, one step of loads in flight while the tensor cores run
  const int steps = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragB b[FN];
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(b[j], &Bs[buf][wn * FN + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        FragA a;
        wmma::load_matrix_sync(a, &As[buf][kk][wm * WM + i * 16][0], 16);
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
    if (t + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // 3. epilogue: y = ((acc * s_x) * s_w) + b, rounded once to T
  int* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int lr = wm * WM + i * 16, gc0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = lr + e / 16, gr = m0 + r, gc = gc0 + e % 16;
        if (gr >= M || gc >= N) continue;
        float y = __fmul_rn(__fmul_rn(__int2float_rn(st[e]), sx[r]), w_scale[gc]);
        if (bias) y = __fadd_rn(y, bias[gc]);
        out[size_t(gr) * N + gc] = from_f<T>(y);
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch(const void* x, long long ldx, const void* w, const float* w_scale, const float* bias,
           void* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || ldx < K ||
      (ldx * static_cast<long long>(sizeof(T))) % 16 != 0 || (M + BM - 1) / BM > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec_w = N % 16 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const signed char* wt = static_cast<const signed char*>(w);
  T* o = static_cast<T*>(out);
  if (vec_w)
    dense_int8_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, ldx, wt, w_scale, bias, o, M,
                                                             K, N);
  else
    dense_int8_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, ldx, wt, w_scale, bias, o,
                                                              M, K, N);
  return int(cudaGetLastError());
}

}  // namespace int8dense
}  // namespace stonkgs

extern "C" int dense_int8(int dtype, const void* x, long long ldx, const void* w,
                          const float* w_scale, const float* bias, void* out, int M, int K,
                          int N, void* stream) {
  using namespace stonkgs::int8dense;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ldx, w, w_scale, bias, out, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, ldx, w, w_scale, bias, out, M, K, N, s);
  return int(cudaErrorInvalidValue);
}
