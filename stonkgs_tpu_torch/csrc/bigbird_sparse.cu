// BigBird block-sparse attention, the middle query blocks, forward and
// backward (HF BigBirdBlockSparseAttention, block size 64, head width 64).
//
// Replaces the TPU kernels _mid_blocks_kernel and _mid_blocks_bwd_kernel
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:83 and :113, which share
// _gather_kv at :51 and _mid_logits at :70).  The backward recomputes the
// forward's logits exactly, so both live here and share slot_block,
// load_slot and the logit formula.
//
// What bounds them on the H100 (S=4096, H=12, bs=64, r=3: W = 8 key blocks
// of 64 per middle query block): the forward at B=8 moves 4 x 50.3 MB of
// q, k, v and out against 49.9 GFLOP of products, bound by bytes (0.061
// ms against 0.050 ms at 989 TFLOP/s); the backward at B=2 does 31.2
// GFLOP against ~101 MB, bound by operations.  See
// stonkgs_tpu_torch/ops/bigbird_sparse.py for the numbers.
//
// bf16 runs the Hopper kernels of bigbird_sm90.cuh (TMA rings, wgmma; the
// forward's two passes as the dense attention's, the backward's dK and dV
// added with TMA reduce-adds).  The fp32 bodies here exist to hold the
// model against the CPU: one block of 128 threads (4 warps of 16 query
// rows) per (middle query block j, head h, batch b), query block i = j +
// 1, streaming the 5 + r key slots [g0 | window i-1, i, i+1 | g_last |
// random r] one 64-key tile at a time from the (B, S, H, D) layout with
// strides into shared memory, with the slot penalties of bigbird_sm90.cuh.
//
// Forward, two passes over the slots (the TPU kernel normalises before it
// rounds, which rules out the online softmax): pass 1 the row max m and
// sum l of exp; pass 2 p = exp(s - m) / l, O += P V in fp32.  lse = m +
// log l.  Logits as _mid_logits: s = Q K^T * scale + penalty (the
// roundings to the input type are the identity in fp32).
//
// Backward: the block keeps q, dO of its rows, and the row statistics lse
// and delta = sum(dO * O); per slot tile it recomputes p = exp(s - lse),
// dP = dO V^T, dS = p (dP - delta) * scale, accumulates dQ += dS K in
// registers, and forms the slot's dK = dS^T q and dV = p^T dO, which it
// adds into the (B, S, H, D) accumulators with atomicAdd (blocks run in no
// order; the TPU kernel carries them across its sequential j axis).  The
// products are plain fp32 FMAs.
//
// C interface (pointers on the device; q, k, v share the element strides
// sb, ss, sh of their (B, S, H, D) view, the last axis contiguous; out,
// dout are (B, (nb-2)*64, H, 64) and lse (B, H, (nb-2)*64), contiguous;
// mask (B, S) fp32; rand (H, nb-2, r) int32; dq (B, S, H, 64) of q's type
// and dk, dv fp32 accumulators of that shape, contiguous and zeroed):
//   int bigbird_mid_fwd(int dtype /*0 fp32, 1 bf16*/, q, k, v, mask, rand,
//                       out, lse, int B, int S, int H, int r,
//                       long long sb, long long ss, long long sh,
//                       float scale, cudaStream_t stream)
//   int bigbird_mid_bwd(int dtype, q, k, v, mask, rand, out, lse, dout, dq,
//                       dk, dv, int B, int S, int H, int r, sb, ss, sh,
//                       float scale, cudaStream_t stream)
// each returning cudaGetLastError() after its launch.

#include "attention.cuh"
#include "bigbird_sm90.cuh"

namespace stonkgs {
namespace bigbird {
namespace {

using attn::kD;
using attn::kSST;
using attn::kThreads;
using attn::kTile;
using attn::load_rows;
using attn::PvAcc;
using attn::score_tile;
using attn::Sizes;
using attn::store_rows;
using T = float;  // the SIMT bodies' type (bf16 runs bigbird_sm90.cuh)

// Slot t's K (and V) tile into shared memory, with its penalty vector;
// barriers on both sides.
__device__ __forceinline__ void load_slot(const Geo& g, const T* k, const T* v, const float* mask_b,
                                          const int* rand_hj, size_t head_off, int j, int t,
                                          T* ks, T* vs, float* pen) {
  const int blk = slot_block(rand_hj, t, j, g.nb);
  const size_t off = head_off + size_t(blk) * kTile * g.ss;
  __syncthreads();  // the previous tile is consumed
  load_rows<T>(ks, k + off, g.ss, kTile);
  if (vs) load_rows<T>(vs, v + off, g.ss, kTile);
  if (threadIdx.x < kTile)
    pen[threadIdx.x] = slot_penalty(mask_b, blk, threadIdx.x, dup_slot(t, j, g.nb));
  __syncthreads();
}

// the masked logit of a Q K^T sum (_mid_logits in fp32)
__device__ __forceinline__ float logit(float qk, float scale, float pen) {
  return qk * scale + pen;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mid_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const int* __restrict__ rand,
               T* __restrict__ out, float* __restrict__ lse, Geo g) {
  using Z = Sizes<T>;
  constexpr int TS = Z::TS;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, slots = 5 + g.r;

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
  T* pw = pst + warp * 16 * TS;

  load_rows<T>(qs, q + head_off + size_t(j + 1) * kTile * g.ss, g.ss, kTile);

  const int row = lane >> 1, half = lane & 1;
  float m = -INFINITY, l = 0.f;
  // pass 1: running max and sum of exp over every slot's keys
  for (int t = 0; t < slots; ++t) {
    load_slot(g, k, v, mask_b, rand_hj, head_off, j, t, ks, nullptr, pen);
    score_tile<T>(qw, ks, sw, lane);
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
  const int r0 = j * kTile + warp * 16;  // the warp's first row among the middle rows
  if (half == 0) lse[(size_t(b) * g.H + h) * (size_t(n_mid) * kTile) + r0 + row] = m + logf(l);

  // pass 2: O = P V, P = round(exp(s - m) / l)
  PvAcc<T> acc;
  acc.zero();
  for (int t = 0; t < slots; ++t) {
    load_slot(g, k, v, mask_b, rand_hj, head_off, j, t, ks, vs, pen);
    score_tile<T>(qw, ks, sw, lane);
    for (int c = half; c < kTile; c += 2)
      pw[row * TS + c] = expf(logit(sw[row * kSST + c], g.scale, pen[c]) - m) / l;
    __syncwarp();
    acc.mma(pw, vs, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  const size_t ors = size_t(g.H) * kD;  // row stride of out
  store_rows<T>(out + (size_t(b) * n_mid * kTile + r0) * ors + size_t(h) * kD, ors, sw, 16, 1.f,
                lane);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A warp's fp32 (16 x D) accumulator of A^T B products: rows are 16 keys
// [key0, key0 + 16) of A (64 query rows x 64 keys, stride TS), B is 64
// query rows x D (stride TS); lane owns columns lane and lane + 32.
struct TAcc {
  static constexpr int TS = Sizes<T>::TS;
  float o[16][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i][0] = o[i][1] = 0.f;
  }
  __device__ __forceinline__ void mma(const T* a, const T* bm, int key0, int lane) {
    for (int r = 0; r < kTile; ++r) {
      const float b0 = bm[r * TS + lane], b1 = bm[r * TS + lane + 32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = a[r * TS + key0 + i];
        o[i][0] += x * b0;
        o[i][1] += x * b1;
      }
    }
  }
  __device__ __forceinline__ void store(float* sw, int lane) const {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sw[i * kSST + lane] = o[i][0];
      sw[i * kSST + lane + 32] = o[i][1];
    }
    __syncwarp();
  }
};

// 16 rows of a warp's fp32 staging tile added into an fp32 (.., D) array
// with row stride rs
__device__ __forceinline__ void atomic_add_rows(float* dst, size_t rs, const float* sw, int lane) {
  for (int e = lane; e < 16 * kD; e += 32) {
    const int r = e / kD, c = e % kD;
    atomicAdd(dst + r * rs + c, sw[r * kSST + c]);
  }
}

constexpr size_t bwd_smem_bytes() {
  using Z = Sizes<T>;
  // q, dO, K, V, P, dS tiles; two per-warp fp32 staging areas; penalty,
  // lse and delta vectors
  return 6 * Z::tile + 2 * Z::stage + 3 * Z::vec;
}

__global__ void __launch_bounds__(kThreads)
mid_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const int* __restrict__ rand,
               const T* __restrict__ out, const float* __restrict__ lse,
               const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ dv, Geo g) {
  using Z = Sizes<T>;
  constexpr int TS = Z::TS;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, slots = 5 + g.r;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + Z::tile);
  T* ks = reinterpret_cast<T*>(smem + 2 * Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 3 * Z::tile);
  T* pt = reinterpret_cast<T*>(smem + 4 * Z::tile);
  T* dst = reinterpret_cast<T*>(smem + 5 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 6 * Z::tile);
  float* dpst = reinterpret_cast<float*>(smem + 6 * Z::tile + Z::stage);
  float* pen = reinterpret_cast<float*>(smem + 6 * Z::tile + 2 * Z::stage);
  float* lse_s = pen + Z::vec / sizeof(float);
  float* delta_s = lse_s + Z::vec / sizeof(float);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off = size_t(b) * g.sb + size_t(h) * g.sh;
  const int* rand_hj = rand + (size_t(h) * n_mid + j) * g.r;
  const float* mask_b = mask + size_t(b) * g.S;
  const size_t ors = size_t(g.H) * kD;                                     // out, dout, dq, dk, dv rows
  const size_t mid0 = (size_t(b) * n_mid * kTile + size_t(j) * kTile) * ors + size_t(h) * kD;
  const size_t full_b = size_t(b) * g.S * ors + size_t(h) * kD;          // (b, 0, h, 0) of dq, dk, dv

  load_rows<T>(qs, q + head_off + size_t(j + 1) * kTile * g.ss, g.ss, kTile);
  load_rows<T>(dos, dout + mid0, ors, kTile);
  load_rows<T>(ks, out + mid0, ors, kTile);  // O, for delta
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    float s = 0.f;
    for (int d = 0; d < kD; ++d) s += dos[r * TS + d] * ks[r * TS + d];
    delta_s[r] = s;
    lse_s[r] = lse[(size_t(b) * g.H + h) * (size_t(n_mid) * kTile) + size_t(j) * kTile + r];
  }

  const int wr = warp * 16;  // the warp's rows
  const T* qw = qs + wr * TS;
  const T* dow = dos + wr * TS;
  float* sw = sst + warp * 16 * kSST;
  float* dpw = dpst + warp * 16 * kSST;
  PvAcc<T> dq_acc;
  dq_acc.zero();
  for (int t = 0; t < slots; ++t) {
    load_slot(g, k, v, mask_b, rand_hj, head_off, j, t, ks, vs, pen);
    score_tile<T>(qw, ks, sw, lane);   // Q K^T
    score_tile<T>(dow, vs, dpw, lane); // dO V^T
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int r = e / kTile, c = e % kTile;
      const float p = expf(logit(sw[r * kSST + c], g.scale, pen[c]) - lse_s[wr + r]);
      const float ds = p * (dpw[r * kSST + c] - delta_s[wr + r]) * g.scale;
      const int at = (wr + r) * TS + c;
      pt[at] = p;
      dst[at] = ds;
    }
    __syncwarp();
    dq_acc.mma(dst + wr * TS, ks, lane);
    __syncthreads();  // every warp's rows of P and dS are in

    // the slot's dK and dV rows [key0, key0 + 16) of this warp
    const int blk = slot_block(rand_hj, t, j, g.nb);
    const size_t key_rows = full_b + size_t(blk * kTile + wr) * ors;
    TAcc acc;
    acc.zero();
    acc.mma(dst, qs, wr, lane);
    acc.store(sw, lane);
    atomic_add_rows(dk + key_rows, ors, sw, lane);
    acc.zero();
    acc.mma(pt, dos, wr, lane);
    acc.store(dpw, lane);
    atomic_add_rows(dv + key_rows, ors, dpw, lane);
  }
  dq_acc.store(sw, lane);
  store_rows<T>(dq + full_b + size_t((j + 1) * kTile + wr) * ors, ors, sw, 16, 1.f, lane);
}

int launch_fwd(const void* q, const void* k, const void* v, const float* mask, const int* rand,
               void* out, float* lse, int B, const Geo& g, cudaStream_t stream) {
  using Z = Sizes<T>;
  constexpr size_t smem = 3 * Z::tile + Z::stage + Z::wtile + Z::vec;
  cudaError_t e = cudaFuncSetAttribute(mid_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(g.nb - 2, g.H, B);
  mid_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, rand,
      static_cast<T*>(out), lse, g);
  return int(cudaGetLastError());
}

int launch_bwd(const void* q, const void* k, const void* v, const float* mask, const int* rand,
               const void* out, const float* lse, const void* dout, void* dq, float* dk,
               float* dv, int B, const Geo& g, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(mid_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(g.nb - 2, g.H, B);
  mid_bwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, rand,
      static_cast<const T*>(out), lse, static_cast<const T*>(dout), static_cast<T*>(dq), dk, dv,
      g);
  return int(cudaGetLastError());
}

bool bad_geometry(int B, int S, int H, int r) {
  return B <= 0 || H <= 0 || r < 0 || S % kTile != 0 || S / kTile < 5 || B > 65535 ||
         H > 65535;
}

// the bf16 kernels round a logit once: 1/sqrt(64) is a power of two
bool power_of_two(float x) {
  int e;
  return x > 0.f && std::frexp(x, &e) == 0.5f;
}

}  // namespace
}  // namespace bigbird
}  // namespace stonkgs

extern "C" int bigbird_mid_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, void* out, float* lse, int B,
                               int S, int H, int r, long long sb, long long ss, long long sh,
                               float scale, void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r)) return int(cudaErrorInvalidValue);
  const Geo g{S, H, S / kTile, r, sb, ss, sh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd(q, k, v, mask, rand, out, lse, B, g, s);
  if (dtype == 1 && power_of_two(scale))
    return stonkgs::bigbird90::launch_fwd_sm90(q, k, v, mask, rand, out, lse, B, g, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int bigbird_mid_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, const void* out,
                               const float* lse, const void* dout, void* dq, float* dk, float* dv,
                               int B, int S, int H, int r, long long sb, long long ss,
                               long long sh, float scale, void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r)) return int(cudaErrorInvalidValue);
  const Geo g{S, H, S / kTile, r, sb, ss, sh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B, g, s);
  if (dtype == 1 && power_of_two(scale))
    return stonkgs::bigbird90::launch_bwd_sm90(q, k, v, mask, rand, out, lse, dout, dq, dk, dv,
                                               B, g, s);
  return int(cudaErrorInvalidValue);
}
