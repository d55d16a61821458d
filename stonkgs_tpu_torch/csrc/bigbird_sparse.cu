// BigBird block-sparse attention, the middle query blocks, forward and
// backward (HF BigBirdBlockSparseAttention), at head width D = 16, 32 or
// 64 and a block size bs that is any multiple of 8 from 8 to 1,024.
//
// Replaces the TPU kernels _mid_blocks_kernel and _mid_blocks_bwd_kernel
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:83 and :113, which share
// _gather_kv at :51 and _mid_logits at :70).  The backward recomputes the
// forward's logits exactly, so both live here and share slot_block,
// tile_penalty and the logit formula.
//
// What bounds them on the H100 (S=4096, H=12, bs=64, r=3, D=64: W = 8 key
// blocks of 64 per middle query block): the forward at B=8 moves 4 x 50.3
// MB of q, k, v and out against 49.9 GFLOP of products, bound by bytes
// (0.061 ms against 0.050 ms at 989 TFLOP/s); the backward at B=2 does
// 31.2 GFLOP against ~101 MB, bound by operations.  At bs=128 (W = 1,024
// keys) the products nearly double and both are bound by operations.  See
// stonkgs_tpu_torch/ops/bigbird_sparse.py for the numbers.
//
// bf16 runs the Hopper kernels of bigbird_sm90.cuh (TMA rings, wgmma; the
// forward's two passes as the dense attention's, the backward's dK and dV
// added with TMA reduce-adds).  The fp32 bodies here exist to hold the
// model against the CPU: one block of 128 threads (4 warps of 16 query
// rows) per 64-row tile u of middle query block j (T = ceil(bs / 64) tiles
// a block: the grid's x is j * T + u), head h and batch b, query block i =
// j + 1, streaming the 5 + r key slots [g0 | window i-1, i, i+1 | g_last |
// random r] one 64-key sub-tile at a time (T sub-tiles a slot) from the
// (B, S, H, D) layout with strides into shared memory, with the slot
// penalties of bigbird_sm90.cuh.  A partial tile (bs not a multiple of 64)
// loads only the block's rows and keys (zeros past them): keys past bs take
// the penalty -inf (weight 0), rows past bs are not stored and get p = dS =
// 0 in the backward, and only the block's keys take dK and dV adds.
//
// Forward, two passes over the slots' sub-tiles (the TPU kernel normalises
// before it rounds, which rules out the online softmax): pass 1 the row
// max m and sum l of exp; pass 2 p = exp(s - m) / l, O += P V in fp32.
// lse = m + log l.  Logits as _mid_logits: s = Q K^T * scale + penalty
// (the roundings to the input type are the identity in fp32).
//
// Backward: the block keeps q, dO of its rows, and the row statistics lse
// and delta = sum(dO * O); per key sub-tile it recomputes p = exp(s - lse),
// dP = dO V^T, dS = p (dP - delta) * scale, accumulates dQ += dS K in
// registers, and forms the sub-tile's dK = dS^T q and dV = p^T dO, which
// it adds into the (B, S, H, D) accumulators with atomicAdd (blocks run
// in no order; the TPU kernel carries them across its sequential j axis).
// The products are plain fp32 FMAs.
//
// C interface (pointers on the device; q, k, v share the element strides
// sb, ss, sh of their (B, S, H, D) view, the last axis contiguous; out,
// dout are (B, (nb-2)*bs, H, D) and lse (B, H, (nb-2)*bs), contiguous;
// mask (B, S) fp32; rand (H, nb-2, r) int32; dq (B, S, H, D) of q's type
// and dk, dv fp32 accumulators of that shape, contiguous and zeroed; scale
// is 1/sqrt(D); a block size that is not a multiple of 8 from 8 to 1,024,
// S not a multiple of it or fewer than 5 blocks, a head width other than
// 16, 32 or 64, or in bf16 a scale whose bf16 rounding is not 1/sqrt(D)'s
// returns cudaErrorInvalidValue and launches nothing):
//   int bigbird_mid_fwd(int dtype /*0 fp32, 1 bf16*/, q, k, v, mask, rand,
//                       out, lse, int B, int S, int H, int r, int bs, int D,
//                       long long sb, long long ss, long long sh,
//                       float scale, cudaStream_t stream)
//   int bigbird_mid_bwd(int dtype, q, k, v, mask, rand, out, lse, dout, dq,
//                       dk, dv, int B, int S, int H, int r, int bs, int D,
//                       sb, ss, sh, float scale, cudaStream_t stream)
// each returning cudaGetLastError() after its launch.

#include "attention.cuh"
#include "bigbird_sm90.cuh"

namespace stonkgs {
namespace bigbird {
namespace {

using attn::kSST;
using attn::kThreads;
using attn::kTile;
using attn::load_rows;
using attn::PvAcc;
using attn::score_tile;
using attn::Sizes;
using attn::store_rows;
using attn::with_head_dim;
using T = float;  // the SIMT bodies' type (bf16 runs bigbird_sm90.cuh)

// the first key (a row of S) of 64-key sub-tile u of slot t of middle
// query block j
__device__ __forceinline__ int tile_key0(const Geo& g, const int* rand_hj, int j, int t, int u) {
  return slot_block(rand_hj, t, j, g.nb) * g.bs + u * kTile;
}

// Sub-tile u of slot t: its K (and V) rows of the block into shared memory
// (zeros past them), with its penalty vector (-inf past the block);
// barriers on both sides
template <int D>
__device__ __forceinline__ void load_slot(const Geo& g, const T* k, const T* v, const float* mask_b,
                                          const int* rand_hj, size_t head_off, int j, int t,
                                          int u, T* ks, T* vs, float* pen) {
  const int key0 = tile_key0(g, rand_hj, j, t, u);
  const int n = min(kTile, g.bs - u * kTile);
  const size_t off = head_off + size_t(key0) * g.ss;
  __syncthreads();  // the previous sub-tile is consumed
  load_rows<T, D>(ks, k + off, g.ss, n);
  if (vs) load_rows<T, D>(vs, v + off, g.ss, n);
  if (threadIdx.x < kTile)
    pen[threadIdx.x] = tile_penalty(mask_b, key0, threadIdx.x, u, g.bs, dup_slot(t, j, g.nb));
  __syncthreads();
}

// the masked logit of a Q K^T sum (_mid_logits in fp32)
__device__ __forceinline__ float logit(float qk, float scale, float pen) {
  return qk * scale + pen;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
mid_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const int* __restrict__ rand,
               T* __restrict__ out, float* __restrict__ lse, Geo g) {
  using Z = Sizes<T, D>;
  constexpr int TS = Z::TS, PS = Z::PS;
  const int sub = tiles_of(g.bs);
  const int j = blockIdx.x / sub, u = blockIdx.x % sub, h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, tiles = (5 + g.r) * sub;
  const int mrow0 = j * g.bs + u * kTile;         // first row among the middle rows
  const int n_rows = min(kTile, g.bs - u * kTile);  // the tile's rows in the block

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 2 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 3 * Z::tile);
  T* pst = reinterpret_cast<T*>(smem + 3 * Z::tile + Z::stage);
  float* pen = reinterpret_cast<float*>(smem + 3 * Z::tile + Z::stage + Z::wtile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off = size_t(b) * g.sb + size_t(h) * g.sh;
  const int* rand_hj = rand + (size_t(h) * n_mid + j) * g.r;
  const float* mask_b = mask + size_t(b) * g.S;
  const T* qw = qs + warp * 16 * TS;
  float* sw = sst + warp * 16 * kSST;
  T* pw = pst + warp * 16 * PS;

  load_rows<T, D>(qs, q + head_off + size_t(g.bs + mrow0) * g.ss, g.ss, n_rows);

  const int row = lane >> 1, half = lane & 1;
  float m = -INFINITY, l = 0.f;
  // pass 1: running max and sum of exp over every slot's keys
  for (int x = 0; x < tiles; ++x) {
    load_slot<D>(g, k, v, mask_b, rand_hj, head_off, j, x / sub, x % sub, ks, nullptr, pen);
    score_tile<T, D>(qw, ks, sw, lane);
    float tmax = -INFINITY;
    for (int c = half; c < kTile; c += 2)
      tmax = fmaxf(tmax, logit(sw[row * kSST + c], g.scale, pen[c]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float tsum = 0.f;
    for (int c = half; c < kTile; c += 2)
      tsum += expf(logit(sw[row * kSST + c], g.scale, pen[c]) - m_new);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - m_new) + tsum;
    m = m_new;
    __syncwarp();
  }
  const int r0 = warp * 16;  // the warp's first row of the tile
  if (half == 0 && r0 + row < n_rows)
    lse[(size_t(b) * g.H + h) * (size_t(n_mid) * g.bs) + mrow0 + r0 + row] = m + logf(l);

  // pass 2: O = P V, P = round(exp(s - m) / l)
  PvAcc<T, D> acc;
  acc.zero();
  for (int x = 0; x < tiles; ++x) {
    load_slot<D>(g, k, v, mask_b, rand_hj, head_off, j, x / sub, x % sub, ks, vs, pen);
    score_tile<T, D>(qw, ks, sw, lane);
    for (int c = half; c < kTile; c += 2)
      pw[row * PS + c] = expf(logit(sw[row * kSST + c], g.scale, pen[c]) - m) / l;
    __syncwarp();
    acc.mma(pw, vs, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  const size_t ors = size_t(g.H) * D;  // row stride of out
  store_rows<T, D>(out + (size_t(b) * n_mid * g.bs + mrow0 + r0) * ors + size_t(h) * D, ors, sw,
                   n_rows - r0, 1.f, lane);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A warp's fp32 (16 x D) accumulator of A^T B products: rows are 16 keys
// [key0, key0 + 16) of A (64 query rows x 64 keys, stride PS), B is 64
// query rows x D (stride TS); lane owns columns lane + 32c below D.
template <int D>
struct TAcc {
  static constexpr int TS = Sizes<T, D>::TS, PS = Sizes<T, D>::PS;
  static constexpr int kC = (D + 31) / 32;
  float o[16][kC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  }
  __device__ __forceinline__ void mma(const T* a, const T* bm, int key0, int lane) {
    for (int r = 0; r < kTile; ++r) {
      float bv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) bv[c] = lane + 32 * c < D ? bm[r * TS + lane + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = a[r * PS + key0 + i];
#pragma unroll
        for (int c = 0; c < kC; ++c) o[i][c] += x * bv[c];
      }
    }
  }
  __device__ __forceinline__ void store(float* sw, int lane) const {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (lane + 32 * c < D) sw[i * kSST + lane + 32 * c] = o[i][c];
    __syncwarp();
  }
};

// the first n (<= 16) rows of a warp's fp32 staging tile added into an
// fp32 (.., D) array with row stride rs
template <int D>
__device__ __forceinline__ void atomic_add_rows(float* dst, size_t rs, const float* sw, int n,
                                                int lane) {
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (r < n) atomicAdd(dst + r * rs + c, sw[r * kSST + c]);
  }
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  using Z = Sizes<T, D>;
  // q, dO, K, V tiles; P and dS tiles (64 keys a row); two per-warp fp32
  // staging areas; penalty, lse and delta vectors
  return 4 * Z::tile + 2 * align128(size_t(kTile) * Z::PS * sizeof(T)) + 2 * Z::stage +
         3 * Z::vec;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mid_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const int* __restrict__ rand,
               const T* __restrict__ out, const float* __restrict__ lse,
               const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ dv, Geo g) {
  using Z = Sizes<T, D>;
  constexpr int TS = Z::TS, PS = Z::PS;
  constexpr size_t ptile = align128(size_t(kTile) * PS * sizeof(T));
  const int sub = tiles_of(g.bs);
  const int j = blockIdx.x / sub, u = blockIdx.x % sub, h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, tiles = (5 + g.r) * sub;
  const int mrow0 = j * g.bs + u * kTile;         // first row among the middle rows
  const int n_rows = min(kTile, g.bs - u * kTile);  // the tile's rows in the block

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + Z::tile);
  T* ks = reinterpret_cast<T*>(smem + 2 * Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 3 * Z::tile);
  T* pt = reinterpret_cast<T*>(smem + 4 * Z::tile);
  T* dst = reinterpret_cast<T*>(smem + 4 * Z::tile + ptile);
  float* sst = reinterpret_cast<float*>(smem + 4 * Z::tile + 2 * ptile);
  float* dpst = reinterpret_cast<float*>(smem + 4 * Z::tile + 2 * ptile + Z::stage);
  float* pen = reinterpret_cast<float*>(smem + 4 * Z::tile + 2 * ptile + 2 * Z::stage);
  float* lse_s = pen + Z::vec / sizeof(float);
  float* delta_s = lse_s + Z::vec / sizeof(float);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off = size_t(b) * g.sb + size_t(h) * g.sh;
  const int* rand_hj = rand + (size_t(h) * n_mid + j) * g.r;
  const float* mask_b = mask + size_t(b) * g.S;
  const size_t ors = size_t(g.H) * D;                                     // out, dout, dq, dk, dv rows
  const size_t mid0 = (size_t(b) * n_mid * g.bs + mrow0) * ors + size_t(h) * D;
  const size_t full_b = size_t(b) * g.S * ors + size_t(h) * D;          // (b, 0, h, 0) of dq, dk, dv

  load_rows<T, D>(qs, q + head_off + size_t(g.bs + mrow0) * g.ss, g.ss, n_rows);
  load_rows<T, D>(dos, dout + mid0, ors, n_rows);
  load_rows<T, D>(ks, out + mid0, ors, n_rows);  // O, for delta
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += dos[r * TS + d] * ks[r * TS + d];
    delta_s[r] = s;
    lse_s[r] = r < n_rows ? lse[(size_t(b) * g.H + h) * (size_t(n_mid) * g.bs) + mrow0 + r] : 0.f;
  }

  const int wr = warp * 16;  // the warp's rows (and, in dK and dV, its keys)
  const T* qw = qs + wr * TS;
  const T* dow = dos + wr * TS;
  float* sw = sst + warp * 16 * kSST;
  float* dpw = dpst + warp * 16 * kSST;
  PvAcc<T, D> dq_acc;
  dq_acc.zero();
  for (int x = 0; x < tiles; ++x) {
    load_slot<D>(g, k, v, mask_b, rand_hj, head_off, j, x / sub, x % sub, ks, vs, pen);
    score_tile<T, D>(qw, ks, sw, lane);   // Q K^T
    score_tile<T, D>(dow, vs, dpw, lane); // dO V^T
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int r = e / kTile, c = e % kTile;
      float p = 0.f, ds = 0.f;   // rows past the block add nothing
      if (wr + r < n_rows) {
        p = expf(logit(sw[r * kSST + c], g.scale, pen[c]) - lse_s[wr + r]);
        ds = p * (dpw[r * kSST + c] - delta_s[wr + r]) * g.scale;
      }
      const int at = (wr + r) * PS + c;
      pt[at] = p;
      dst[at] = ds;
    }
    __syncwarp();
    dq_acc.mma(dst + wr * PS, ks, lane);
    __syncthreads();  // every warp's rows of P and dS are in

    // the sub-tile's dK and dV rows [wr, wr + 16) of this warp, the keys
    // in the block only
    const int sub_u = x % sub;
    const int n_keys = min(kTile, g.bs - sub_u * kTile) - wr;
    if (n_keys > 0) {
      const int key0 = tile_key0(g, rand_hj, j, x / sub, sub_u);
      const size_t key_rows = full_b + size_t(key0 + wr) * ors;
      TAcc<D> acc;
      acc.zero();
      acc.mma(dst, qs, wr, lane);
      acc.store(sw, lane);
      atomic_add_rows<D>(dk + key_rows, ors, sw, n_keys, lane);
      acc.zero();
      acc.mma(pt, dos, wr, lane);
      acc.store(dpw, lane);
      atomic_add_rows<D>(dv + key_rows, ors, dpw, n_keys, lane);
    }
  }
  dq_acc.store(sw, lane);
  store_rows<T, D>(dq + full_b + size_t(g.bs + mrow0 + wr) * ors, ors, sw, n_rows - wr, 1.f,
                   lane);
}

int launch_fwd(const void* q, const void* k, const void* v, const float* mask, const int* rand,
               void* out, float* lse, int B, int D, const Geo& g, cudaStream_t stream) {
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    using Z = Sizes<T, kD>;
    constexpr size_t smem = 3 * Z::tile + Z::stage + Z::wtile + Z::vec;
    cudaError_t e = cudaFuncSetAttribute(mid_fwd_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((g.nb - 2) * tiles_of(g.bs), g.H, B);
    mid_fwd_kernel<kD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        rand, static_cast<T*>(out), lse, g);
    return int(cudaGetLastError());
  });
}

int launch_bwd(const void* q, const void* k, const void* v, const float* mask, const int* rand,
               const void* out, const float* lse, const void* dout, void* dq, float* dk,
               float* dv, int B, int D, const Geo& g, cudaStream_t stream) {
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    constexpr size_t smem = bwd_smem_bytes<kD>();
    cudaError_t e = cudaFuncSetAttribute(mid_bwd_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((g.nb - 2) * tiles_of(g.bs), g.H, B);
    mid_bwd_kernel<kD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        rand, static_cast<const T*>(out), lse, static_cast<const T*>(dout), static_cast<T*>(dq),
        dk, dv, g);
    return int(cudaGetLastError());
  });
}

// the kernels' domain (ops/bigbird_sparse.py::bigbird_kernel_takes): a
// block size that is a multiple of 8 from 8 to 1,024, at least 5 blocks,
// head width 16, 32 or 64
bool bad_geometry(int B, int S, int H, int r, int bs, int D) {
  return B <= 0 || H <= 0 || r < 0 || bs < 8 || bs > 1024 || bs % 8 != 0 ||
         (D != 16 && D != 32 && D != 64) || S % bs != 0 || S / bs < 5 || B > 65535 ||
         H > 65535;
}

// the geometry of a call
Geo geo_of(int S, int H, int r, int bs, long long sb, long long ss, long long sh, float scale) {
  return Geo{S, H, S / bs, r, bs, sb, ss, sh, scale};
}

// the bf16 kernels fix the logit scale by D: 1/sqrt(D) rounded to bf16
bool bad_bf16_scale(float scale, int D) {
  const float s = __bfloat162float(__float2bfloat16(scale));
  return with_head_dim(D, [&](auto d) {
    return int(s != bigbird90::kLogitScale<decltype(d)::value>);
  }) != 0;
}

}  // namespace
}  // namespace bigbird
}  // namespace stonkgs

extern "C" int bigbird_mid_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, void* out, float* lse, int B,
                               int S, int H, int r, int bs, int D, long long sb, long long ss,
                               long long sh, float scale, void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r, bs, D)) return int(cudaErrorInvalidValue);
  const Geo g = geo_of(S, H, r, bs, sb, ss, sh, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd(q, k, v, mask, rand, out, lse, B, D, g, s);
  if (dtype == 1 && !bad_bf16_scale(scale, D))
    return stonkgs::bigbird90::launch_fwd_sm90(q, k, v, mask, rand, out, lse, B, D, g, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int bigbird_mid_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, const void* out,
                               const float* lse, const void* dout, void* dq, float* dk, float* dv,
                               int B, int S, int H, int r, int bs, int D, long long sb,
                               long long ss, long long sh, float scale, void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r, bs, D)) return int(cudaErrorInvalidValue);
  const Geo g = geo_of(S, H, r, bs, sb, ss, sh, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B, D, g, s);
  if (dtype == 1 && !bad_bf16_scale(scale, D))
    return stonkgs::bigbird90::launch_bwd_sm90(q, k, v, mask, rand, out, lse, dout, dq, dk, dv,
                                               B, D, g, s);
  return int(cudaErrorInvalidValue);
}
