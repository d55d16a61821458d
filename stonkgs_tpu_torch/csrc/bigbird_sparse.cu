// BigBird block-sparse attention, the middle query blocks, forward and
// backward (HF BigBirdBlockSparseAttention), at any head width d that is a
// multiple of 8 (the wrappers pad any other) and any block size bs >= 1
// with at least 5 blocks: the bf16 Hopper kernels of bigbird_sm90.cuh up
// to d = 64, past it the bf16 forward of bigbird_wide_sm90.cuh and the
// SIMT bodies here (the bf16 backward and everything in fp32).
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
// bf16 up to d = 64 runs the Hopper kernels of bigbird_sm90.cuh (TMA
// rings, wgmma; the forward's two passes as the dense attention's, the
// backward's dK and dV added with TMA reduce-adds), at any block size: a
// block is ceil(bs / 64) row tiles, the last one partial (masked) where bs
// is no multiple of 64, several blocks' rows in one tile below 64.  Past
// d = 64, where those kernels' shared memory has no room (their forward
// ring holds 4 stages of two 64 x d K and V tiles a query block, 256 KB at
// d = 128; their backward two fp32 64 x d staging tiles a consumer), the
// bf16 forward runs bigbird_wide_sm90.cuh (the scores over the full d in
// column blocks of 64 on wgmma, O in column parts of 128, a statistics
// launch past d = 128).  The SIMT bodies here run fp32 at every d (they
// exist to hold the model against the CPU) and the bf16 backward past d =
// 64.  A SIMT body is instantiated at the padded widths D = 16, 32 and 64
// (the tiles D wide, zero past d; the stores and adds skip the columns
// from d on); past d = 64 at D = 64 in column parts: ceil(d / 64) CTAs a
// tile, each forming the full-d scores over 64-column chunks of Q and K
// (and dP of dO and V) through the same tiles, the chunk of its own part
// last, so that the tiles then hold the part's columns for its products (P
// V; dS K, dS^T Q, P^T dO).  Each part keeps its own softmax statistics
// over the true scores; the first writes lse.  The scores are formed once
// a part: (d / 64) times the products of one pass.  One block of 128
// threads (4 warps of 16 query rows) per 64-row tile u of middle query
// block j (T = ceil(bs / 64) tiles a block) and part: the grid's x is (j *
// T + u) * parts + part, head h and batch b, query block i = j + 1,
// streaming the 5 + r key slots [g0 | window i-1, i, i+1 | g_last | random
// r] one 64-key sub-tile at a time (T sub-tiles a slot) from the (B, S, H,
// d) layout with strides into shared memory, with the slot penalties of
// bigbird_sm90.cuh.  A partial tile (bs not a multiple of 64) loads only
// the block's rows and keys (zeros past them): keys past bs take the
// penalty -inf (weight 0), rows past bs are not stored and get p = dS = 0
// in the backward, and only the block's keys take dK and dV adds.
//
// Forward (fp32), two passes over the slots' sub-tiles (the TPU kernel
// normalises before it rounds, which rules out the online softmax): pass 1
// the row max m and sum l of exp; pass 2 p = exp(s - m) / l, O += P V.
// lse = m + log l.  Logits as _mid_logits: s = Q K^T * scale + penalty in
// fp32; in bf16 (the backward) s = round(round(Q K^T) * scale) + penalty
// with the scale rounded to bf16, as the Hopper kernels' padded instances.
//
// Backward: the block keeps its rows' lse and delta = sum(dO * O) (over
// the full d); per key sub-tile it recomputes p = exp(s - lse), dP = dO
// V^T, dS = p (dP - delta) * scale in fp32, accumulates dQ += dS K in
// registers, and forms the sub-tile's dK = dS^T q and dV = round(p)^T dO,
// which it adds into the (B, S, H, d) fp32 accumulators with atomicAdd
// (blocks run in no order; the TPU kernel carries them across its
// sequential j axis).  The products are plain fp32 FMAs.
//
// C interface (pointers on the device; q, k, v share the element strides
// sb, ss, sh of their (B, S, H, D) view, the last axis contiguous; out,
// dout are (B, (nb-2)*bs, H, D) and lse (B, H, (nb-2)*bs), contiguous;
// mask (B, S) fp32; rand (H, nb-2, r) int32; dq (B, S, H, D) of q's type
// and dk, dv fp32 accumulators of that shape, contiguous and zeroed; D is
// the tensors' head width and scale 1/sqrt(d) of the true head width d,
// D - 8 < d <= D (a caller pads a d that is not a multiple of 8 with zero
// columns; bf16 rounds the scale to bf16 and takes the logit at it); a
// block size below 1, S not a multiple of it or fewer than 5 blocks, a
// head width D that is not a positive multiple of 8, or in bf16 a scale
// whose bf16 rounding is no such d's returns cudaErrorInvalidValue and
// launches nothing):
//   int bigbird_mid_fwd(int dtype /*0 fp32, 1 bf16*/, q, k, v, mask, rand,
//                       out, lse, float* stats /*bf16 at D > 128: (B, H,
//                       (nb-2)*bs) x 2 fp32 scratch, required; else
//                       unused*/, int B, int S, int H, int r, int bs, int D,
//                       long long sb, long long ss, long long sh,
//                       float scale, cudaStream_t stream)
//   int bigbird_mid_bwd(int dtype, q, k, v, mask, rand, out, lse, dout, dq,
//                       dk, dv, int B, int S, int H, int r, int bs, int D,
//                       sb, ss, sh, float scale, cudaStream_t stream)
// each returning cudaGetLastError() after its launches;
//   int bigbird_mid_fwd_wide_calls(void)
// the forward's calls so far that ran bigbird_fwd_wide_sm90_kernel (bf16
// past D = 64).

#include "attention.cuh"
#include "bigbird_sm90.cuh"
#include "bigbird_wide_sm90.cuh"

namespace stonkgs {
namespace bigbird {
namespace {

using attn::kD;  // the widest padded width; past it, column parts of it
using attn::kSST;
using attn::kThreads;
using attn::kTile;
using attn::load_rows;
using attn::PvAcc;
using attn::score_tile;
using attn::Sizes;
using attn::store_rows;
using attn::with_padded_head_dim;
using bf16 = __nv_bfloat16;

// the first key (a row of S) of 64-key sub-tile u of slot t of middle
// query block j
__device__ __forceinline__ int tile_key0(const Geo& g, const int* rand_hj, int j, int t, int u) {
  return slot_block(rand_hj, t, j, g.nb) * g.bs + u * kTile;
}

// the masked logit of a Q K^T sum (_mid_logits): fp32 at the call's
// scale; bf16 rounded to bf16, times the bf16 scale, rounded again
template <typename T>
__device__ __forceinline__ float logit(float qk, const Geo& g, float pen) {
  if constexpr (kIsBf16<T>) return round_to<T>(round_to<T>(qk) * g.logit) + pen;
  return qk * g.scale + pen;
}

// The CTA's tile of a SIMT body: middle query block j, its 64-row tile u
// and the column part; the tile's rows in the block and the part's
// columns [c0, c0 + dw) of the head's d
template <int D>
struct TileOf {
  int j, u, part, parts, sub, n_rows, mrow0, c0, dw;
  __device__ __forceinline__ TileOf(const Geo& g) {
    parts = (g.d + D - 1) / D;
    sub = tiles_of(g.bs);
    part = int(blockIdx.x) % parts;
    const int tile = int(blockIdx.x) / parts;
    j = tile / sub;
    u = tile % sub;
    mrow0 = j * g.bs + u * kTile;              // first row among the middle rows
    n_rows = min(kTile, g.bs - u * kTile);     // the tile's rows in the block
    c0 = part * D;
    dw = min(D, g.d - c0);
  }
  // the i-th of the parts' chunks in the order a sub-tile walks them: the
  // part's own last
  __device__ __forceinline__ int chunk(int i) const { return (part + 1 + i) % parts; }
};

// Sub-tile u of slot t, chunk cc (columns [cc D, cc D + D)): its K (and V)
// rows of the block into shared memory (zeros past them), with its
// penalty vector (-inf past the block); when the head is wider than one
// chunk, the query tile's rows of Q (and dO, given) at the chunk too;
// barriers on both sides
template <typename T, int D>
__device__ __forceinline__ void load_chunk(const Geo& g, const TileOf<D>& tl, const T* k,
                                           const T* v, const float* mask_b, const int* rand_hj,
                                           size_t head_off, int t, int u, int cc, T* ks, T* vs,
                                           float* pen, const T* qrow, T* qs, const T* dorow,
                                           size_t dors, T* dos) {
  const int key0 = tile_key0(g, rand_hj, tl.j, t, u);
  const int n = min(kTile, g.bs - u * kTile);
  const int col = cc * D, w = min(D, g.d - col);
  const size_t off = head_off + size_t(key0) * g.ss + col;
  __syncthreads();  // the previous sub-tile is consumed
  load_rows<T, D>(ks, k + off, g.ss, n, w);
  if (vs) load_rows<T, D>(vs, v + off, g.ss, n, w);
  if (tl.parts > 1) {
    load_rows<T, D>(qs, qrow + col, g.ss, tl.n_rows, w);
    if (dos) load_rows<T, D>(dos, dorow + col, dors, tl.n_rows, w);
  }
  if (threadIdx.x < kTile)
    pen[threadIdx.x] = tile_penalty(mask_b, key0, threadIdx.x, u, g.bs, dup_slot(t, tl.j, g.nb));
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  using Z = Sizes<float, D>;
  return 3 * Z::tile + Z::stage + Z::wtile + Z::vec;
}

// the fp32 forward (bf16 runs the Hopper kernels at every d)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mid_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const int* __restrict__ rand, float* __restrict__ out, float* __restrict__ lse,
               Geo g) {
  using T = float;
  using Z = Sizes<T, D>;
  constexpr int TS = Z::TS, PS = Z::PS;
  const TileOf<D> tl(g);
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, tiles = (5 + g.r) * tl.sub;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 2 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 3 * Z::tile);
  T* pst = reinterpret_cast<T*>(smem + 3 * Z::tile + Z::stage);
  float* pen = reinterpret_cast<float*>(smem + 3 * Z::tile + Z::stage + Z::wtile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off = size_t(b) * g.sb + size_t(h) * g.sh;
  const int* rand_hj = rand + (size_t(h) * n_mid + tl.j) * g.r;
  const float* mask_b = mask + size_t(b) * g.S;
  const T* qrow = q + head_off + size_t(g.bs + tl.mrow0) * g.ss;  // the tile's first query row
  const T* qw = qs + warp * 16 * TS;
  float* sw = sst + warp * 16 * kSST;
  T* pw = pst + warp * 16 * PS;

  if (tl.parts == 1) load_rows<T, D>(qs, qrow, g.ss, tl.n_rows, g.d);
  // the logits' Q K^T of sub-tile x into sw, over every chunk (V of the
  // part's columns loaded with the last)
  auto scores = [&](int x, bool with_v) {
    for (int i = 0; i < tl.parts; ++i) {
      const bool last = i == tl.parts - 1;
      load_chunk<T, D>(g, tl, k, v, mask_b, rand_hj, head_off, x / tl.sub, x % tl.sub,
                       tl.chunk(i), ks, with_v && last ? vs : nullptr, pen, qrow, qs, nullptr,
                       0, nullptr);
      score_tile<T, D>(qw, ks, sw, lane, i > 0);
    }
  };

  const int row = lane >> 1, half = lane & 1;
  float m = -INFINITY, l = 0.f;
  // pass 1: running max and sum of exp over every slot's keys
  for (int x = 0; x < tiles; ++x) {
    scores(x, false);
    float tmax = -INFINITY;
    for (int c = half; c < kTile; c += 2)
      tmax = fmaxf(tmax, logit<T>(sw[row * kSST + c], g, pen[c]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float tsum = 0.f;
    for (int c = half; c < kTile; c += 2)
      tsum += expf(logit<T>(sw[row * kSST + c], g, pen[c]) - m_new);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - m_new) + tsum;
    m = m_new;
    __syncwarp();
  }
  const int r0 = warp * 16;  // the warp's first row of the tile
  if (tl.part == 0 && half == 0 && r0 + row < tl.n_rows)
    lse[(size_t(b) * g.H + h) * (size_t(n_mid) * g.bs) + tl.mrow0 + r0 + row] = m + logf(l);

  // pass 2: O = P V, P = round(exp(s - m) / l)
  PvAcc<T, D> acc;
  acc.zero();
  for (int x = 0; x < tiles; ++x) {
    scores(x, true);
    for (int c = half; c < kTile; c += 2)
      pw[row * PS + c] = from_f<T>(expf(logit<T>(sw[row * kSST + c], g, pen[c]) - m) / l);
    __syncwarp();
    acc.mma(pw, vs, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  const size_t ors = size_t(g.H) * g.d;  // row stride of out
  store_rows<T, D>(out + (size_t(b) * n_mid * g.bs + tl.mrow0 + r0) * ors + size_t(h) * g.d +
                       tl.c0,
                   ors, sw, tl.n_rows - r0, 1.f, lane, tl.dw);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A warp's fp32 (16 x D) accumulator of A^T B products: rows are 16 keys
// [key0, key0 + 16) of A (64 query rows x 64 keys of TA, stride `as`), B is
// 64 query rows x D of T (stride TS); lane owns columns lane + 32c below D.
template <typename T, int D>
struct TAcc {
  static constexpr int TS = Sizes<T, D>::TS;
  static constexpr int kC = (D + 31) / 32;
  float o[16][kC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  }
  template <typename TA>
  __device__ __forceinline__ void mma(const TA* a, int as, const T* bm, int key0, int lane) {
    for (int r = 0; r < kTile; ++r) {
      float bv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        bv[c] = lane + 32 * c < D ? to_f(bm[r * TS + lane + 32 * c]) : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = to_f(a[r * as + key0 + i]);
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

// the first n (<= 16) rows and w columns of a warp's fp32 staging tile
// added into an fp32 (.., w) array with row stride rs
template <int D>
__device__ __forceinline__ void atomic_add_rows(float* dst, size_t rs, const float* sw, int n,
                                                int w, int lane) {
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (r < n && c < w) atomicAdd(dst + r * rs + c, sw[r * kSST + c]);
  }
}

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  using Z = Sizes<T, D>;
  // q, dO, K, V tiles; P (T) and dS (fp32) tiles, 64 keys a row; two
  // per-warp fp32 staging areas; penalty, lse and delta vectors
  return 4 * Z::tile + align128(size_t(kTile) * Z::PS * sizeof(T)) +
         align128(size_t(kTile) * Sizes<float, D>::PS * sizeof(float)) + 2 * Z::stage +
         3 * Z::vec;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mid_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ mask, const int* __restrict__ rand,
               const T* __restrict__ out, const float* __restrict__ lse,
               const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ dv, Geo g) {
  using Z = Sizes<T, D>;
  constexpr int TS = Z::TS, PS = Z::PS, PSF = Sizes<float, D>::PS;
  constexpr size_t ptile = align128(size_t(kTile) * PS * sizeof(T));
  constexpr size_t dstile = align128(size_t(kTile) * PSF * sizeof(float));
  const TileOf<D> tl(g);
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, tiles = (5 + g.r) * tl.sub;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + Z::tile);
  T* ks = reinterpret_cast<T*>(smem + 2 * Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 3 * Z::tile);
  T* pt = reinterpret_cast<T*>(smem + 4 * Z::tile);
  float* dst = reinterpret_cast<float*>(smem + 4 * Z::tile + ptile);
  float* sst = reinterpret_cast<float*>(smem + 4 * Z::tile + ptile + dstile);
  float* dpst = reinterpret_cast<float*>(smem + 4 * Z::tile + ptile + dstile + Z::stage);
  float* pen = reinterpret_cast<float*>(smem + 4 * Z::tile + ptile + dstile + 2 * Z::stage);
  float* lse_s = pen + Z::vec / sizeof(float);
  float* delta_s = lse_s + Z::vec / sizeof(float);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off = size_t(b) * g.sb + size_t(h) * g.sh;
  const int* rand_hj = rand + (size_t(h) * n_mid + tl.j) * g.r;
  const float* mask_b = mask + size_t(b) * g.S;
  const size_t ors = size_t(g.H) * g.d;                                   // out, dout, dq, dk, dv rows
  const size_t mid0 = (size_t(b) * n_mid * g.bs + tl.mrow0) * ors + size_t(h) * g.d;
  const size_t full_b = size_t(b) * g.S * ors + size_t(h) * g.d;        // (b, 0, h, 0) of dq, dk, dv
  const T* qrow = q + head_off + size_t(g.bs + tl.mrow0) * g.ss;

  // delta = rowsum(dO * O) over every chunk of the head (O staged in ks)
  float dsum = 0.f;
  for (int cc = 0; cc < tl.parts; ++cc) {
    const int w = min(D, g.d - cc * D);
    __syncthreads();
    load_rows<T, D>(dos, dout + mid0 + cc * D, ors, tl.n_rows, w);
    load_rows<T, D>(ks, out + mid0 + cc * D, ors, tl.n_rows, w);
    __syncthreads();
    if (threadIdx.x < kTile)
      for (int d = 0; d < D; ++d)
        dsum += to_f(dos[threadIdx.x * TS + d]) * to_f(ks[threadIdx.x * TS + d]);
  }
  if (tl.parts == 1) load_rows<T, D>(qs, qrow, g.ss, tl.n_rows, g.d);  // dO stays in dos
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    delta_s[r] = dsum;
    lse_s[r] =
        r < tl.n_rows ? lse[(size_t(b) * g.H + h) * (size_t(n_mid) * g.bs) + tl.mrow0 + r] : 0.f;
  }

  const int wr = warp * 16;  // the warp's rows (and, in dK and dV, its keys)
  const T* qw = qs + wr * TS;
  const T* dow = dos + wr * TS;
  float* sw = sst + warp * 16 * kSST;
  float* dpw = dpst + warp * 16 * kSST;
  PvAcc<T, D> dq_acc;
  dq_acc.zero();
  for (int x = 0; x < tiles; ++x) {
    // Q K^T and dO V^T over every chunk; the tiles then hold the part's
    for (int i = 0; i < tl.parts; ++i) {
      load_chunk<T, D>(g, tl, k, v, mask_b, rand_hj, head_off, x / tl.sub, x % tl.sub,
                       tl.chunk(i), ks, vs, pen, qrow, qs, dout + mid0, ors, dos);
      score_tile<T, D>(qw, ks, sw, lane, i > 0);   // Q K^T
      score_tile<T, D>(dow, vs, dpw, lane, i > 0); // dO V^T
    }
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int r = e / kTile, c = e % kTile;
      float p = 0.f, ds = 0.f;   // rows past the block add nothing
      if (wr + r < tl.n_rows) {
        p = expf(logit<T>(sw[r * kSST + c], g, pen[c]) - lse_s[wr + r]);
        ds = p * (dpw[r * kSST + c] - delta_s[wr + r]) * g.scale;
      }
      pt[(wr + r) * PS + c] = from_f<T>(p);
      dst[(wr + r) * PSF + c] = ds;
    }
    __syncwarp();
    dq_acc.mma(dst + wr * PSF, ks, lane, PSF);
    __syncthreads();  // every warp's rows of P and dS are in

    // the sub-tile's dK and dV rows [wr, wr + 16) of this warp, the keys
    // in the block only, the part's columns
    const int sub_u = x % tl.sub;
    const int n_keys = min(kTile, g.bs - sub_u * kTile) - wr;
    if (n_keys > 0) {
      const int key0 = tile_key0(g, rand_hj, tl.j, x / tl.sub, sub_u);
      const size_t key_rows = full_b + size_t(key0 + wr) * ors + tl.c0;
      TAcc<T, D> acc;
      acc.zero();
      acc.mma(dst, PSF, qs, wr, lane);
      acc.store(sw, lane);
      atomic_add_rows<D>(dk + key_rows, ors, sw, n_keys, tl.dw, lane);
      acc.zero();
      acc.mma(pt, PS, dos, wr, lane);
      acc.store(dpw, lane);
      atomic_add_rows<D>(dv + key_rows, ors, dpw, n_keys, tl.dw, lane);
    }
  }
  dq_acc.store(sw, lane);
  store_rows<T, D>(dq + full_b + size_t(g.bs + tl.mrow0 + wr) * ors + tl.c0, ors, sw,
                   tl.n_rows - wr, 1.f, lane, tl.dw);
}

// the grid of a SIMT body at padded width D: a CTA a (tile, part)
template <int D>
inline dim3 simt_grid(int B, const Geo& g) {
  return dim3((g.nb - 2) * tiles_of(g.bs) * ((g.d + D - 1) / D), g.H, B);
}

template <int D>
int launch_fwd_t(const void* q, const void* k, const void* v, const float* mask,
                 const int* rand, void* out, float* lse, int B, const Geo& g,
                 cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(mid_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  mid_fwd_kernel<D><<<simt_grid<D>(B, g), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, rand, static_cast<float*>(out), lse, g);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_t(const void* q, const void* k, const void* v, const float* mask,
                 const int* rand, const void* out, const float* lse, const void* dout, void* dq,
                 float* dk, float* dv, int B, const Geo& g, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(mid_bwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  mid_bwd_kernel<T, D><<<simt_grid<D>(B, g), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, rand,
      static_cast<const T*>(out), lse, static_cast<const T*>(dout), static_cast<T*>(dq), dk, dv,
      g);
  return int(cudaGetLastError());
}

// the fp32 SIMT bodies: the padded width up to 64, column parts of 64 past it
int launch_fwd_f32(const void* q, const void* k, const void* v, const float* mask,
                   const int* rand, void* out, float* lse, int B, const Geo& g,
                   cudaStream_t stream) {
  if (g.d > kD) return launch_fwd_t<kD>(q, k, v, mask, rand, out, lse, B, g, stream);
  return with_padded_head_dim<kD>(g.d, [&](auto d) {
    return launch_fwd_t<decltype(d)::value>(q, k, v, mask, rand, out, lse, B, g, stream);
  });
}

int launch_bwd_f32(const void* q, const void* k, const void* v, const float* mask,
                   const int* rand, const void* out, const float* lse, const void* dout,
                   void* dq, float* dk, float* dv, int B, const Geo& g, cudaStream_t stream) {
  if (g.d > kD)
    return launch_bwd_t<float, kD>(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B, g,
                                   stream);
  return with_padded_head_dim<kD>(g.d, [&](auto d) {
    return launch_bwd_t<float, decltype(d)::value>(q, k, v, mask, rand, out, lse, dout, dq, dk,
                                                   dv, B, g, stream);
  });
}

// the kernels' domain (ops/bigbird_sparse.py::bigbird_kernel_takes, at the
// padded width): any block size of at least 5 blocks, a head width that
// is a positive multiple of 8; the grid's y and z extents
bool bad_geometry(int B, int S, int H, int r, int bs, int D) {
  return B <= 0 || H <= 0 || r < 0 || bs < 1 || D < 8 || D % 8 != 0 || S % bs != 0 ||
         S / bs < 5 || B > 65535 || H > 65535;
}

// the geometry of a call
Geo geo_of(int S, int H, int r, int bs, int D, long long sb, long long ss, long long sh,
           float scale) {
  return Geo{S, H, S / bs, r, bs, sb, ss, sh, scale, D,
             __bfloat162float(__float2bfloat16(scale))};
}

// the bf16 kernels take the scale 1/sqrt(d), in bf16, of a true head width
// d that the padding to D may hide: D - 8 < d <= D
bool bad_bf16_scale(const Geo& g) {
  for (int d = g.d - 7; d <= g.d; ++d)
    if (g.logit == __bfloat162float(__float2bfloat16(1.0f / std::sqrt(float(d))))) return false;
  return true;
}

}  // namespace
}  // namespace bigbird
}  // namespace stonkgs

extern "C" int bigbird_mid_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, void* out, float* lse,
                               float* stats, int B, int S, int H, int r, int bs, int D,
                               long long sb, long long ss, long long sh, float scale,
                               void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r, bs, D)) return int(cudaErrorInvalidValue);
  const Geo g = geo_of(S, H, r, bs, D, sb, ss, sh, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_f32(q, k, v, mask, rand, out, lse, B, g, s);
  if (dtype != 1 || bad_bf16_scale(g)) return int(cudaErrorInvalidValue);
  if (D > kD)
    return stonkgs::bigbird90::launch_fwd_wide_sm90(q, k, v, mask, rand, out, lse, stats, B, g, s);
  return stonkgs::bigbird90::launch_fwd_sm90(q, k, v, mask, rand, out, lse, B, g, s);
}

extern "C" int bigbird_mid_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const int* rand, const void* out,
                               const float* lse, const void* dout, void* dq, float* dk, float* dv,
                               int B, int S, int H, int r, int bs, int D, long long sb,
                               long long ss, long long sh, float scale, void* stream) {
  using namespace stonkgs::bigbird;
  if (bad_geometry(B, S, H, r, bs, D)) return int(cudaErrorInvalidValue);
  const Geo g = geo_of(S, H, r, bs, D, sb, ss, sh, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_f32(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B, g, s);
  if (dtype != 1 || bad_bf16_scale(g)) return int(cudaErrorInvalidValue);
  if (D > kD)
    return launch_bwd_t<bf16, kD>(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B, g, s);
  return stonkgs::bigbird90::launch_bwd_sm90(q, k, v, mask, rand, out, lse, dout, dq, dk, dv, B,
                                             g, s);
}

extern "C" int bigbird_mid_fwd_wide_calls() { return stonkgs::bigbird90::fwd_wide_calls(); }
