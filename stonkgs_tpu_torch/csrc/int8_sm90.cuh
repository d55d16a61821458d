// The int8 kernels for Hopper (sm_90a), launched by dense_int8.cu and
// int8_gemm.cu: a row-quantize pass and a GEMM whose operands are both
// K-major, the only layout wgmma takes for 8-bit operands.
//
// quantize_rows_kernel: one to eight warps a row of x (fp32 or bf16, rows
// `ldx` elements apart), read once through 16-byte loads and kept in
// registers, at most 4 vectors a lane (a longer row, K > 8,192 in bf16 or
// 4,096 in fp32, is read twice by one warp):
//   s[m]    = max(max_k |x[m, k]| / 127, 1e-12)
//   q[m, k] = clip(rint(x[m, k] / s[m]), -127, 127)    int8, rows K apart
// with an IEEE division by 127 and by s (no reciprocal, no fast math) and
// rintf (half to even): the codes and scales of the plain version
// (ops/quantization.py, quantize_rows) bit for bit.
//
// gemm_kmajor_sm90_kernel: C (M, N) = A (M, K) . B^T for A and B (N, K)
// row-major, s8 x s8 -> s32 (wgmma.m64nNk32.s32.s8.s8) or, as the
// probe's control, bf16 x bf16 -> fp32 (wgmma.m64nNk16.f32.bf16.bf16).
// Persistent: one block an SM (384 threads) walks the BM x BN tiles of C
// t = blockIdx.x, + gridDim.x, ...:
// * warpgroup 2, the producer (setmaxnreg.dec): one thread streams every
//   k-step of every tile of the block, one 128-byte swizzled line of K a
//   stage (128 int8 or 64 bf16 values), through a kStages-deep ring with
//   TMA and full/empty mbarriers: A's BM lines and B's BN lines a stage.
//   TMA zero-fills rows >= M, lines >= N and a ragged K (any K: the maps
//   take the true K, with rows lda and ldb elements apart, so the last
//   k-step's columns past K read as zero codes and add nothing).  The ring runs on across tiles,
//   so the next tile's first stages load during this tile's epilogue;
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own BM / 2 rows
//   each (one or two m64 tiles): four k32 (k16) products a stage, the
//   descriptors advancing 32 bytes a step; a stage is released once the
//   next stage's products are issued (wgmma.wait_group 1);
// * the epilogue either stores the accumulator as it is (the probe) or
//   dequantizes it (the int8 dense):
//     y = round_T(((float(acc) * s_x[m]) * s_w[n]) + b[n])
//   each product and the sum rounded on its own (__fmul_rn, __fadd_rn: no
//   fused multiply-add), as the plain version computes it; s_x, s_w and
//   the bias are fetched when the tile starts, so that the products hide
//   their latency.  Each consumer writes C into its own 32 KB staging area
//   as 64-row boxes of 128-byte swizzled lines (in rounds, when its part
//   of the tile is larger), which one of its threads stores with TMA
//   (rows >= M and columns >= N are not written, so no store is guarded)
//   while the consumers go on to the next tile.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace stonkgs {
namespace int8_90 {

using namespace sm90;

constexpr int kLineBytes = 128;  // K bytes of a ring stage: one swizzled line
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kOutBox = 64 * kLineBytes;  // one 64-row box of C, 8 KB

template <typename TIn> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

// one k-step (32 bytes of K) of an m64 x BN tile: d += A . B^T
template <typename TIn, int BN, typename Acc>
__device__ __forceinline__ void mma_step(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<TIn, int8_t>::value) {
    if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
    else wgmma_s8_n128(d, da, db);
  } else {
    if constexpr (BN == 256) wgmma_n256<0>(d, da, db);
    else wgmma_n128<0>(d, da, db, 1);
  }
}

// two neighbouring values of C as they go into a staged box: bf16 packed
// into 4 bytes, a 32-bit type as 8 bytes
__device__ __forceinline__ void put_pair(unsigned char* p, bf16, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void put_pair(unsigned char* p, float, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put_pair(unsigned char* p, int, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

constexpr int kStageBoxes = 4;  // 64-row boxes of C a consumer stages at once (32 KB)

template <int BM, int BN, int kStages, int kCols>
struct alignas(1024) SmemGemm {
  unsigned char a[kStages][BM * kLineBytes];
  unsigned char b[kStages][BN * kLineBytes];
  unsigned char c[kConsumers][kStageBoxes * kOutBox];  // each consumer's C staging
  float sw[kConsumers][kCols];    // s_w and the bias of the tile's columns
  float bias[kConsumers][kCols];  // (kCols: BN when dequantizing, else 1)
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// C = A . B^T, stored (kDequant false: TOut is the accumulator's type) or
// dequantized with s_x (M,), s_w (N,) and an optional bias (N,) into TOut
template <typename TIn, typename TOut, int BM, int BN, int kStages, bool kDequant>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kmajor_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_c, const float* __restrict__ sx,
                        const float* __restrict__ sw, const float* __restrict__ bias, int M,
                        int N, int K) {
  using Smem = SmemGemm<BM, BN, kStages, kDequant ? BN : 1>;
  using Acc = typename AccOf<TIn>::type;
  constexpr int kMI = BM / (64 * kConsumers);   // m64 tiles of a consumer
  constexpr int kAcc = BN / 2;                  // accumulator registers of one m64 tile
  constexpr int kLineK = kLineBytes / int(sizeof(TIn));  // K values of a line
  constexpr uint32_t kStageBytes = uint32_t(BM + BN) * kLineBytes;
  constexpr int kColsT = kDequant ? BN / 128 : 0;  // columns a consumer thread fetches
  constexpr int kBoxCols = kLineBytes / int(sizeof(TOut));  // columns of a staged box
  constexpr int kBoxesMI = BN / kBoxCols;                    // boxes of an m64 tile
  constexpr int kRounds = (kMI * kBoxesMI + kStageBoxes - 1) / kStageBoxes;
  static_assert(kMI >= 1 && (BN == 128 || BN == 256), "tile shape");
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + BM - 1) / BM);
  const int nk = (K + kLineK - 1) / kLineK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);                // the producer thread (+ TMA bytes)
      mbar_init(&sm.empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer: every k-step of every tile of the block ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      int g = 0;  // the block's k-steps so far: the ring position
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int stage = g % kStages;
          mbar_wait(&sm.empty[stage], ((g / kStages) & 1) ^ 1);
          mbar_arrive_tx(&sm.full[stage], kStageBytes);
          tma_load_2d(sm.a[stage], &map_a, kt * kLineK, m0, &sm.full[stage]);
          tma_load_2d(sm.b[stage], &map_b, kt * kLineK, n0, &sm.full[stage]);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const bool leader = warp == 0 && lane == 0;  // issues this consumer's TMA stores
  unsigned char* staged = sm.c[wg];
  const int r = warp * 16 + lane / 4;  // + 8 acc_row(i), of an m64 tile
  int g = 0;  // the block's k-steps so far: the ring position
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    // the epilogue's factors, fetched now so that the products hide their
    // latency: s_x of this thread's rows, s_w and the bias of columns
    // (zero past M and N)
    float s[kMI][2], colw[kColsT > 0 ? kColsT : 1], colb[kColsT > 0 ? kColsT : 1];
    if constexpr (kDequant) {
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + (wg * kMI + mi) * 64 + r + 8 * h;
          s[mi][h] = row < M ? sx[row] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        const int col = n0 + j * 128 + threadIdx.x % 128;
        colw[j] = col < N ? sw[col] : 0.f;
        colb[j] = col < N && bias ? bias[col] : 0.f;
      }
    }
    Acc acc[kMI][kAcc];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[mi][i] = Acc(0);
    }
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int stage = g % kStages;
      mbar_wait(&sm.full[stage], (g / kStages) & 1);
      const uint64_t db = desc_sw128(sm.b[stage]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) fence_regs(acc[mi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kLineBytes / 32; ++kk) {  // 32 bytes = 2 descriptor units
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          mma_step<TIn, BN>(acc[mi],
                            desc_sw128(sm.a[stage] + (wg * kMI + mi) * 64 * kLineBytes) + 2 * kk,
                            db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) fence_regs(acc[mi]);
      if (kt > 0) release_stage(&sm.empty[(g - 1) % kStages], lane);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) fence_regs(acc[mi]);
    if (nk > 0) release_stage(&sm.empty[(g - 1) % kStages], lane);

    // epilogue, while the producer fills the ring with the next tile's
    // steps: C in rounds of up to kStageBoxes boxes through this
    // consumer's staging area, each stored with TMA.  The column factors
    // go to shared memory (this consumer's last epilogue has read them:
    // it ended at a barrier), visible after round 0's barrier
    if constexpr (kDequant) {
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        sm.sw[wg][j * 128 + threadIdx.x % 128] = colw[j];
        sm.bias[wg][j * 128 + threadIdx.x % 128] = colb[j];
      }
    }
#pragma unroll
    for (int round = 0; round < kRounds; ++round) {
      if (leader) tma_store_read_done();  // the last round's stores have read the area
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < kAcc; i += 4) {  // i, i + 1: row r; i + 2, i + 3: row r + 8
        const int c = acc_col(i, lane);
        const int cbox = 8 * (i / 4) / kBoxCols;  // c's box within the m64 tile
        if (kBoxesMI > kStageBoxes && cbox / kStageBoxes != round) continue;
        float w[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
        if constexpr (kDequant) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            w[e] = sm.sw[wg][c + e];
            b[e] = sm.bias[wg][c + e];
          }
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const int box = mi * kBoxesMI + cbox;  // of the consumer's C
          if (box / kStageBoxes != round) continue;
          unsigned char* bx = staged + (box % kStageBoxes) * kOutBox;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Acc a0 = acc[mi][i + 2 * h], a1 = acc[mi][i + 2 * h + 1];
            unsigned char* p =
                bx + sw128_byte(r + 8 * h, (c - cbox * kBoxCols) * int(sizeof(TOut)));
            if constexpr (kDequant) {
              float y[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                y[e] = __fmul_rn(__fmul_rn(__int2float_rn(e ? a1 : a0), s[mi][h]), w[e]);
                if (bias) y[e] = __fadd_rn(y[e], b[e]);
              }
              put_pair(p, TOut(), y[0], y[1]);
            } else {
              put_pair(p, TOut(), a0, a1);
            }
          }
        }
      }
      fence_async_shared();
      named_barrier(2 + wg, 128);
      if (leader) {
#pragma unroll 1
        for (int j = 0; j < kStageBoxes; ++j) {
          const int box = round * kStageBoxes + j;
          if (box >= kMI * kBoxesMI) break;
          const int row0 = m0 + (wg * kMI + box / kBoxesMI) * 64;
          const int col0 = n0 + (box % kBoxesMI) * kBoxCols;
          if (row0 < M && col0 < N) tma_store_2d(&map_c, staged + j * kOutBox, col0, row0);
        }
        tma_store_commit();
      }
    }
  }
  if (leader) tma_store_read_done();
}

// C (M, N), rows `ldc` elements apart, = A (M, K) . B^T, A and B (N, K)
// row-major with rows `lda` and `ldb` elements apart (0: K; each a
// multiple of 16 bytes, K itself any width: the maps take the true K and
// TMA zero-fills a box's columns past it, so a ragged last k-step adds
// nothing and the padding is never read); sx null: no dequantization
// (TOut the accumulator's type); one block an SM, or one a tile where
// there are fewer tiles
template <typename TIn, typename TOut, int BM, int BN, int kStages, bool kDequant>
int launch_gemm(const void* a, const void* b, void* c, long long ldc, const float* sx,
                const float* sw, const float* bias, int M, int N, int K, cudaStream_t stream,
                long long lda = 0, long long ldb = 0) {
  using Smem = SmemGemm<BM, BN, kStages, kDequant ? BN : 1>;
  constexpr int kLineK = kLineBytes / int(sizeof(TIn));
  if (lda == 0) lda = K;
  if (ldb == 0) ldb = K;
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < K || (lda * sizeof(TIn)) % 16 ||
      (ldb * sizeof(TIn)) % 16 || ldc < N || (ldc * sizeof(TOut)) % 16 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 || (kDequant && (!sx || !sw)))
    return int(cudaErrorInvalidValue);
  CUtensorMap ma, mb, mc;
  if (!make_map_2d<TIn>(&ma, a, M, K, kLineK, BM, lda) ||
      !make_map_2d<TIn>(&mb, b, N, K, kLineK, BN, ldb) ||
      !make_map_2d<TOut>(&mc, c, M, N, kLineBytes / int(sizeof(TOut)), 64, ldc))
    return kErrTensorMap;
  constexpr size_t smem = sizeof(Smem) + 1024;  // + alignment slack
  static_assert(smem <= 232448, "shared memory of a block");
  auto* kernel = gemm_kmajor_sm90_kernel<TIn, TOut, BM, BN, kStages, kDequant>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return int(e);
  const long long tiles = 1LL * ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (tiles > (1LL << 31) - 1) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(ma, mb, mc, sx, sw,
                                                                        bias, M, N, K);
  return int(cudaGetLastError());
}

// --- the row-quantize pass ---------------------------------------------------

constexpr int kQuantRows = 8;  // rows (warps) of a block

// the int8 code of v at scale s, as the low byte of an unsigned
__device__ __forceinline__ unsigned quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// the values of a 16-byte vector as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(b[i]);
}

template <int V>
__device__ __forceinline__ float absmax_vec(float m, const uint4& u) {
  float f[V];
  unpack(u, f);
#pragma unroll
  for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// the V codes of a 16-byte vector at scale s, stored at dst
template <int V>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint4& u, float s) {
  float f[V];
  unpack(u, f);
  unsigned w[V / 4];
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    w[j] = quant(f[4 * j], s) | (quant(f[4 * j + 1], s) << 8) | (quant(f[4 * j + 2], s) << 16) |
           (quant(f[4 * j + 3], s) << 24);
  if constexpr (V == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<unsigned*>(dst) = w[0];
}

// kWarps warps a row, 8 / kWarps rows a block.  kVecs > 0: each lane
// keeps up to kVecs 16-byte vectors of the row in registers (K <= 32 *
// kWarps * kVecs * V); kVecs 0: one warp a row, which reads it twice
template <typename T, int kWarps, int kVecs>
__global__ void __launch_bounds__(32 * kQuantRows)
quantize_rows_kernel(const T* __restrict__ x, long long ldx, int8_t* __restrict__ q,
                     float* __restrict__ sx, int M, int K) {
  constexpr int V = 16 / int(sizeof(T));
  static_assert(kQuantRows % kWarps == 0 && (kVecs > 0 || kWarps == 1), "row split");
  __shared__ float part[kQuantRows];  // each warp's absmax
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kQuantRows / kWarps) + warp / kWarps;
  const int t = (warp % kWarps) * 32 + lane;  // this thread's place in its row
  const bool live = row < M;
  const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(live ? row : 0) * ldx);
  int8_t* qr = q + size_t(row) * K;
  const int nv = K / V;  // vectors of the row
  float m = 0.f;
  if constexpr (kVecs > 0) {
    uint4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = j * 32 * kWarps + t;
      v[j] = live && e < nv ? xr[e] : make_uint4(0u, 0u, 0u, 0u);
      m = absmax_vec<V>(m, v[j]);
    }
    m = warp_max(m);
    if constexpr (kWarps > 1) {
      if (lane == 0) part[warp] = m;
      __syncthreads();
      m = part[warp - warp % kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, part[warp - warp % kWarps + w]);
    }
    if (!live) return;
    const float s = fmaxf(m / 127.0f, 1e-12f);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = j * 32 * kWarps + t;
      if (e < nv) store_codes<V>(qr + e * V, v[j], s);
    }
    if (t == 0) sx[row] = s;
  } else {
    if (!live) return;
    for (int e = lane; e < nv; e += 32) m = absmax_vec<V>(m, xr[e]);
    const float s = fmaxf(warp_max(m) / 127.0f, 1e-12f);
    for (int e = lane; e < nv; e += 32) store_codes<V>(qr + e * V, xr[e], s);
    if (lane == 0) sx[row] = s;
  }
}

template <typename T, int kWarps, int kVecs>
void quantize_launch(const T* x, long long ldx, int8_t* q, float* sx, int M, int K,
                     cudaStream_t stream) {
  constexpr int kRows = kQuantRows / kWarps;
  quantize_rows_kernel<T, kWarps, kVecs>
      <<<unsigned((M + kRows - 1) / kRows), 32 * kQuantRows, 0, stream>>>(x, ldx, q, sx, M, K);
}

// codes q (M, K) and scales sx (M,) of x (M, K), rows `ldx` elements apart
// (16-byte aligned); K a multiple of 16 (the wrapper zero-pads a row of
// any other K to one: a zero adds nothing to the absmax and its code is
// 0, which adds nothing to the product).  A row is split over as few warps
// as keep each lane at 4 vectors or fewer (K <= 8,192 in bf16, 4,096 in
// fp32), so that a block stays small in registers and many are in flight
template <typename T>
int launch_quantize(const void* x, long long ldx, void* q, float* sx, int M, int K,
                    cudaStream_t stream) {
  constexpr int V = 16 / int(sizeof(T));
  if (M <= 0 || K <= 0 || K % 16 || ldx < K || (ldx * sizeof(T)) % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16)
    return int(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  const int nv = K / V;
  if (nv <= 32 * 4)
    quantize_launch<T, 1, 4>(xt, ldx, qt, sx, M, K, stream);
  else if (nv <= 64 * 4)
    quantize_launch<T, 2, 4>(xt, ldx, qt, sx, M, K, stream);
  else if (nv <= 128 * 4)
    quantize_launch<T, 4, 4>(xt, ldx, qt, sx, M, K, stream);
  else if (nv <= 256 * 4)
    quantize_launch<T, 8, 4>(xt, ldx, qt, sx, M, K, stream);
  else
    quantize_launch<T, 1, 0>(xt, ldx, qt, sx, M, K, stream);
  return int(cudaGetLastError());
}

}  // namespace int8_90
}  // namespace stonkgs
