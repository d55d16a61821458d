// Training attention, forward and backward, with the TPU kernels' in-kernel
// hash dropout; q, k, v, out, dO, dq, dk, dv in the (B, S, H, D) layout
// (D a positive multiple of 8: the wrappers pad any other D with zero
// columns; up to 256 each kernel is instantiated at the padded widths 16,
// 32, 64, 128 and 256, and D runs on the smallest at least D, the columns
// past D zero; past that bf16 runs attention_wide_sm90.cuh (the forward,
// in column parts of 128) and attention_bwd_wide_sm90.cuh (the backward:
// a dS pass into a bf16 scratch, then wgmma GEMMs), fp32 a warp a row in
// column parts of 256, attention.cuh and below), read with strides; lse
// and delta (B, H, S) fp32.
//
// Replaces the TPU kernels _train_fwd_kernel and _train_bwd_kernel
// (stonkgs_tpu/ops/flash_attention.py:92 and :118, with _dropout_keep at
// :69).  Bounds on the H100 and the design are in
// stonkgs_tpu_torch/ops/flash_attention.py.
//
// Forward (writes O and the fp32 logsumexp; two passes over the keys, so
// three products and two exps a score, plus the dropout hash of each
// score's position): in bf16 the Hopper kernel attn_fwd_sm90_kernel<true>
// of attention_sm90.cuh (TMA ring fed by a producer warpgroup, wgmma
// products, S and P in registers, exp2 on the SFU and a per-row
// reciprocal: a bf16 probability moves by at most one step at a rounding
// boundary), past D = 256 attn_fwd_wide_sm90_kernel<true> of
// attention_wide_sm90.cuh (a statistics launch writes lse and each row's
// (m, 1/l) into the `stats` scratch, then a block per 128 query rows and
// output column part of 128 runs pass 2); in fp32 the SIMT body
// attn_fwd_kernel<true> of attention.cuh (attn_fwd_rows_kernel past D =
// 128).  The TPU kernel's S_pad - S padded keys enter each row's max and
// sum analytically.
//
// Backward, three launches on the stream:
//   1. delta = rowsum(dO * O) in fp32, one warp per (b, s, h) row;
//   2. dQ: a block per query tile, head and batch streams the keys; per
//      tile S = Q K^T and dP~ = dO V^T, p = exp(S*scale + bias - lse), dP
//      = dP~ * mr with mr = 1/(1-rate) where the hash keeps and 0 where it
//      drops, dS = p (dP - delta) rounded to T, dQ += dS K; dQ = scale * dQ;
//   3. dK, dV, db: a block per key tile, head and batch streams the
//      queries and forms the transposed tiles S^T = K Q^T and dP~^T =
//      V dO^T, then dV += round(p * mr)^T dO and dK += round(dS)^T Q in fp32
//      registers across all query tiles; dK = scale * dK.  db (B, S) = sum
//      over rows and heads of the fp32 dS: each block sums its keys over
//      all rows and adds the result into db with one atomicAdd per key (12
//      heads per address, so the order of the fp32 sum may vary between
//      runs).
// In bf16 up to D = 256, (2) and (3) are the Hopper kernels of
// attention_bwd_sm90.cuh (128-row tiles streamed by TMA, wgmma products,
// S, dP~, dS and P in registers); past D = 256 they are replaced by the
// kernels of attention_bwd_wide_sm90.cuh: a key-major dS pass forms S^T
// and dP~^T once over the full D, writes round(dS)^T and round(p * mr)^T
// into a bf16 scratch and adds db, then wgmma GEMMs form dK and dV, and
// dQ, from it.  In fp32 up to D = 128 (2) and (3) are the SIMT bodies
// below (64-row tiles, plain FMAs through attention.cuh's score_tile and
// PvAcc), which exist to hold the model against the CPU; past 128 a warp
// a (row, column part of 256): attn_bwd_dq_rows_kernel and
// attn_bwd_dkdv_rows_kernel, each score and dP~ a warp-wide sum over the
// full D, formed again by every part.  Parallel over key tiles in (3),
// the backward needs no cross-block reduction for dK and dV; dQ takes the
// second pass (2) instead of atomics, at the cost of computing S and dP~
// twice.
//
// C interface (dtype 0 fp32, 1 bf16; key_bias (B, S) fp32 or NULL; the
// dropout arguments as attention.cuh's Dropout):
//   int flash_attention_train_fwd(int dtype, q, k, v, key_bias, out,
//       float* lse, float* stats /*bf16 at D > 256: (B, H, S) x 2 fp32
//       scratch, required; else unused*/, int B, int S, int H, int D, float scale, int dropout,
//       int s_pad, unsigned threshold, unsigned seed0, unsigned seed1,
//       float keep_scale, cudaStream_t stream)
//   int flash_attention_train_bwd(int dtype, q, k, v, key_bias, out,
//       const float* lse, dout, dq, dk, dv, float* db /*(B, S) zeroed, or
//       NULL*/, float* delta /*(B, H, S) scratch*/, ds, pd /*bf16 at D >
//       256: (group, S, ld) bf16 scratch each, ld = chunk rounded up to a
//       multiple of 8, required; else unused*/, float* dk_carry,
//       float* dv_carry /*bf16 at D > 256 with chunk < S: (B, S, H, D)
//       fp32, required; else unused*/, int B, int S, int H, int D,
//       int group, int chunk /*bf16 at D > 256: heads a group and query
//       rows a chunk of the scratch; else unused*/, float scale,
//       int dropout, int s_pad, unsigned threshold, unsigned seed0,
//       unsigned seed1, float keep_scale, cudaStream_t stream)
// each returns cudaGetLastError() after its launches (cudaErrorInvalidValue,
// with nothing launched, for a D that is not a positive multiple of 8);
//   int flash_attention_train_fwd_wide_calls(void)
//   int flash_attention_train_bwd_wide_calls(void)
// the forward's and the backward's calls so far that ran the kernels past
// D = 256 in bf16 (attn_fwd_wide_sm90_kernel; the backward's dS pass and
// GEMMs).

#include "attention_bwd_sm90.cuh"
#include "attention_bwd_wide_sm90.cuh"
#include "attention_wide_sm90.cuh"

namespace stonkgs {
namespace attn {
namespace {

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], one warp per row
// of D <= kP elements (the loads unrolled over kP; kP = 0: any D, walked at
// run time)
template <typename T, int kP>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int S, int H, int D) {
  const size_t row = size_t(blockIdx.x) * 8 + threadIdx.x / 32;  // (b*S + s)*H + h
  const int lane = threadIdx.x % 32;
  if (row >= size_t(B) * S * H) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  const int n = kP ? kP : D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < n; c += 32)
    if (c < D) acc += to_f(op[c]) * to_f(dp[c]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = int(row % H);
    const size_t bs = row / H;  // b*S + s
    const int s = int(bs % S), b = int(bs / S);
    delta[(size_t(b) * H + h) * S + s] = acc;
  }
}

// Backward shared memory of the fp32 bodies: four tiles, two fp32
// staging tiles (the first also stages the outputs, so it is kP wide),
// two per-warp tiles, four 64-float vectors.  The tiles are kP wide (the
// padded width), the tensors' rows D <= kP.
template <int kP>
constexpr size_t bwd_smem_bytes() {
  using Z = Sizes<float, kP>;
  return 4 * Z::tile + Z::ostage + Z::stage + 2 * Z::wtile + 4 * Z::vec;
}

template <int kP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ key_bias, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int S, int H, int D, float scale,
                   Dropout drop) {
  using Z = Sizes<float, kP>;
  constexpr int TS = Z::TS;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + Z::tile);
  float* ks = reinterpret_cast<float*>(smem + 2 * Z::tile);
  float* vs = reinterpret_cast<float*>(smem + 3 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 4 * Z::tile);
  float* pst = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage);
  float* dst = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage + Z::stage);
  float* bs = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage + Z::stage + 2 * Z::wtile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * D;
  const size_t head0 = (size_t(b) * S * H + h) * D;
  const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
  const size_t stat0 = (size_t(b) * H + h) * S;  // (b, h, 0) of lse and delta

  load_rows<float, kP>(qs, q + head0 + size_t(q0) * rs, rs, min(kTile, S - q0), D);
  load_rows<float, kP>(dos, dout + head0 + size_t(q0) * rs, rs, min(kTile, S - q0), D);

  const float* qw = qs + warp * 16 * TS;
  const float* dow = dos + warp * 16 * TS;
  float* sw = sst + warp * 16 * Z::OS;  // S tile, then dQ
  float* pw = pst + warp * 16 * kSST;   // dP~ tile
  float* dsw = dst + warp * 16 * Z::PS;  // dS tile

  const int row = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + row;
  const bool live = qrow < S;
  const float lse_r = live ? lse[stat0 + qrow] : 0.f;
  const float delta_r = live ? delta[stat0 + qrow] : 0.f;
  const uint32_t base = drop.row_base(b * H + h, qrow);

  PvAcc<float, kP> acc;
  acc.zero();
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int n = min(kTile, S - k0);
    __syncthreads();  // the previous tiles are consumed
    load_rows<float, kP>(ks, k + head0 + size_t(k0) * rs, rs, n, D);
    load_rows<float, kP>(vs, v + head0 + size_t(k0) * rs, rs, n, D);
    load_vec(bs, kb ? kb + k0 : nullptr, n);
    __syncthreads();
    score_tile<float, kP>(qw, ks, sw, lane);
    score_tile<float, kP>(dow, vs, pw, lane);
    for (int c = half; c < kTile; c += 2) {
      float ds = 0.f;
      if (live && c < n) {
        const float p = expf(sw[row * kSST + c] * scale + bs[c] - lse_r);
        float dp = pw[row * kSST + c];
        if (drop.enabled) dp = drop.keep(base + uint32_t(k0 + c)) ? dp * drop.keep_scale : 0.f;
        ds = p * (dp - delta_r);
      }
      dsw[row * Z::PS + c] = ds;
    }
    __syncwarp();
    acc.mma(dsw, ks, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  store_rows<float, kP>(dq + head0 + size_t(q0 + warp * 16) * rs, rs, sw,
                        S - (q0 + warp * 16), scale, lane, D);
}

template <int kP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_bias, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ db, int S,
                     int H, int D, float scale, Dropout drop) {
  using Z = Sizes<float, kP>;
  constexpr int TS = Z::TS;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + Z::tile);
  float* qs = reinterpret_cast<float*>(smem + 2 * Z::tile);
  float* dos = reinterpret_cast<float*>(smem + 3 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 4 * Z::tile);
  float* pst = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage);
  float* pdt = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage + Z::stage);
  float* dst = reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage + Z::stage + Z::wtile);
  float* vecs =
      reinterpret_cast<float*>(smem + 4 * Z::tile + Z::ostage + Z::stage + 2 * Z::wtile);
  float* bs = vecs;                            // bias of the block's keys
  float* lse_s = vecs + Z::vec / sizeof(float);  // lse and delta of the query tile
  float* delta_s = vecs + 2 * Z::vec / sizeof(float);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * D;
  const size_t head0 = (size_t(b) * S * H + h) * D;
  const size_t stat0 = (size_t(b) * H + h) * S;
  const int nk = min(kTile, S - k0);

  load_rows<float, kP>(ks, k + head0 + size_t(k0) * rs, rs, nk, D);
  load_rows<float, kP>(vs, v + head0 + size_t(k0) * rs, rs, nk, D);
  load_vec(bs, key_bias ? key_bias + size_t(b) * S + k0 : nullptr, nk);

  const float* kw = ks + warp * 16 * TS;   // the warp's 16 keys
  const float* vw = vs + warp * 16 * TS;
  float* sw = sst + warp * 16 * Z::OS;  // S^T tile (keys x queries), then dV and dK
  float* pw = pst + warp * 16 * kSST;   // dP~^T tile
  float* pdw = pdt + warp * 16 * Z::PS;  // (p * mr)^T
  float* dsw = dst + warp * 16 * Z::PS;  // dS^T

  const int row = lane >> 1, half = lane & 1;
  const int key = k0 + warp * 16 + row;  // this lane's key
  const bool live = key < S;
  const int bh = b * H + h;

  PvAcc<float, kP> dv_acc, dk_acc;
  dv_acc.zero();
  dk_acc.zero();
  float db_acc = 0.f;
  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int nq = min(kTile, S - q0);
    __syncthreads();  // the previous query tile is consumed
    load_rows<float, kP>(qs, q + head0 + size_t(q0) * rs, rs, nq, D);
    load_rows<float, kP>(dos, dout + head0 + size_t(q0) * rs, rs, nq, D);
    load_vec(lse_s, lse + stat0 + q0, nq);
    load_vec(delta_s, delta + stat0 + q0, nq);
    __syncthreads();
    score_tile<float, kP>(kw, qs, sw, lane);
    score_tile<float, kP>(vw, dos, pw, lane);
    const float bias_r = bs[warp * 16 + row];
    for (int c = half; c < kTile; c += 2) {
      float pd = 0.f, ds = 0.f;
      if (live && c < nq) {
        const float p = expf(sw[row * kSST + c] * scale + bias_r - lse_s[c]);
        float dp = pw[row * kSST + c];
        pd = p;
        if (drop.enabled) {
          const bool kept = drop.keep(drop.row_base(bh, q0 + c) + uint32_t(key));
          pd = kept ? p * drop.keep_scale : 0.f;
          dp = kept ? dp * drop.keep_scale : 0.f;
        }
        ds = p * (dp - delta_s[c]);
      }
      pdw[row * Z::PS + c] = pd;
      dsw[row * Z::PS + c] = ds;
      db_acc += ds;
    }
    __syncwarp();
    dv_acc.mma(pdw, dos, lane);
    dk_acc.mma(dsw, qs, lane);
    __syncwarp();
  }
  const int rows_left = S - (k0 + warp * 16);
  dv_acc.store(sw, lane);
  store_rows<float, kP>(dv + head0 + size_t(k0 + warp * 16) * rs, rs, sw, rows_left, 1.f,
                        lane, D);
  __syncwarp();  // dV is read out before dK takes its place
  dk_acc.store(sw, lane);
  store_rows<float, kP>(dk + head0 + size_t(k0 + warp * 16) * rs, rs, sw, rows_left, scale,
                        lane, D);
  db_acc += __shfl_xor_sync(0xffffffffu, db_acc, 1);
  if (db && live && half == 0) atomicAdd(db + size_t(b) * S + key, db_acc);
}

// dQ past the tiled widths in fp32, as attn_bwd_dq_kernel computes it: a
// warp a (b, h, query row, column part), the keys walked from L2 kRowKeys
// at a time: s = q.k and dP~ = dO.v as warp-wide sums over the full D, p =
// exp(s*scale + bias - lse), dS = p (dP~ * mr - delta), dQ += dS k over
// the part's columns
__global__ void __launch_bounds__(32 * kRowWarps, 1)
attn_bwd_dq_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ key_bias,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                        int D, float scale, Dropout drop) {
  RowPart rp;
  if (!row_part(S, H, D, rp)) return;
  const int lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * D, head0 = (size_t(rp.b) * S * H + rp.h) * D;
  const size_t row = head0 + size_t(rp.s) * rs;
  const int c0 = rp.part * kPartCols + 8 * lane;
  const float* kb = key_bias ? key_bias + size_t(rp.b) * S : nullptr;
  const float lse_r = lse[rp.bhs], delta_r = delta[rp.bhs];
  const uint32_t base = drop.row_base(rp.b * H + rp.h, rp.s);
  float acc[8] = {};
  for (int j0 = 0; j0 < S; j0 += kRowKeys) {
    const int n = min(kRowKeys, S - j0);
    const size_t at0 = head0 + size_t(j0) * rs;
    float s[kRowKeys], dps[kRowKeys];
    row_dots(s, q + row, k + at0, rs, n, D, lane);
    row_dots(dps, dout + row, v + at0, rs, n, D, lane);
#pragma unroll
    for (int u = 0; u < kRowKeys; ++u) {
      if (u >= n) break;
      const int j = j0 + u;
      const float p = expf(s[u] * scale + (kb ? kb[j] : 0.f) - lse_r);
      float dp = dps[u];
      if (drop.enabled) dp = drop.keep(base + uint32_t(j)) ? dp * drop.keep_scale : 0.f;
      if (c0 < D) axpy8(acc, p * (dp - delta_r), k + at0 + u * rs + c0);
    }
  }
  if (c0 < D) store8(dq + row + c0, acc, scale);
}

// dK, dV and db past the tiled widths in fp32, as attn_bwd_dkdv_kernel
// computes them: a warp a (b, h, key, column part), the query rows walked
// from L2 kRowKeys at a time: s = k.q and dP~ = v.dO over the full D, p =
// exp(s*scale + bias - lse[row]), dV += (p * mr) dO, dS = p (dP~ * mr -
// delta[row]), dK += dS q over the part's columns; the first part's warp
// adds the key's db, the sum of its dS over rows (one atomicAdd a head)
__global__ void __launch_bounds__(32 * kRowWarps, 1)
attn_bwd_dkdv_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ key_bias,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ db, int S, int H, int D,
                          float scale, Dropout drop) {
  RowPart rp;
  if (!row_part(S, H, D, rp)) return;
  const int lane = threadIdx.x % 32, key = rp.s, bh = rp.b * H + rp.h;
  const size_t rs = size_t(H) * D, head0 = (size_t(rp.b) * S * H + rp.h) * D;
  const size_t row = head0 + size_t(key) * rs, stat0 = size_t(bh) * S;
  const int c0 = rp.part * kPartCols + 8 * lane;
  const float bias_r = key_bias ? key_bias[size_t(rp.b) * S + key] : 0.f;
  float dk_acc[8] = {}, dv_acc[8] = {};
  float db_acc = 0.f;
  for (int i0 = 0; i0 < S; i0 += kRowKeys) {
    const int n = min(kRowKeys, S - i0);
    const size_t at0 = head0 + size_t(i0) * rs;
    float s[kRowKeys], dps[kRowKeys];
    row_dots(s, k + row, q + at0, rs, n, D, lane);
    row_dots(dps, v + row, dout + at0, rs, n, D, lane);
#pragma unroll
    for (int u = 0; u < kRowKeys; ++u) {
      if (u >= n) break;
      const int i = i0 + u;
      const size_t at = at0 + u * rs;
      const float p = expf(s[u] * scale + bias_r - lse[stat0 + i]);
      float dp = dps[u], pd = p;
      if (drop.enabled) {
        const bool kept = drop.keep(drop.row_base(bh, i) + uint32_t(key));
        pd = kept ? p * drop.keep_scale : 0.f;
        dp = kept ? dp * drop.keep_scale : 0.f;
      }
      const float ds = p * (dp - delta[stat0 + i]);
      db_acc += ds;
      if (c0 < D) {
        axpy8(dv_acc, pd, dout + at + c0);
        axpy8(dk_acc, ds, q + at + c0);
      }
    }
  }
  if (c0 < D) {
    store8(dv + row + c0, dv_acc, 1.f);
    store8(dk + row + c0, dk_acc, scale);
  }
  if (db && rp.part == 0 && lane == 0) atomicAdd(db + size_t(rp.b) * S + key, db_acc);
}

// delta = rowsum(dO * O), then dQ and dK/dV/db: the Hopper kernels in
// bf16 up to P = 256 and the dS pass and GEMMs past it, the tiled SIMT
// bodies in fp32 up to P = 128 and the kernels of a warp a row past them
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* key_bias,
               const void* out, const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* db, float* delta, void* ds, void* pd, float* dk_carry,
               float* dv_carry, int B, int S, int H, int D, int group, int chunk, float scale,
               Dropout drop, cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return int(cudaErrorInvalidValue);
  const unsigned delta_blocks = unsigned((size_t(B) * S * H + 7) / 8);
  if (D > (kIsBf16<T> ? kMaxHeadDim : kTiledMaxHeadDim)) {
    if (kIsBf16<T> && !attn90::bwd_wide_args_ok(B, H, S, D, group, chunk, ds, pd, dk_carry,
                                                dv_carry))
      return int(cudaErrorInvalidValue);
    attn_bwd_delta_kernel<T, 0><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, S, H, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    if constexpr (kIsBf16<T>) {
      return attn90::launch_bwd_wide_sm90(q, k, v, key_bias, lse, dout, delta, dq, dk, dv, db,
                                          ds, pd, dk_carry, dv_carry, B, S, H, D, group, chunk,
                                          scale, drop, stream);
    } else {
      const float* qt = static_cast<const float*>(q);
      const float* kt = static_cast<const float*>(k);
      const float* vt = static_cast<const float*>(v);
      const float* dot = static_cast<const float*>(dout);
      const dim3 blocks = row_grid(B, S, H, D);
      attn_bwd_dq_rows_kernel<<<blocks, 32 * kRowWarps, 0, stream>>>(
          qt, kt, vt, key_bias, dot, lse, delta, static_cast<float*>(dq), S, H, D, scale, drop);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
      attn_bwd_dkdv_rows_kernel<<<blocks, 32 * kRowWarps, 0, stream>>>(
          qt, kt, vt, key_bias, dot, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), db, S, H, D, scale, drop);
      return int(cudaGetLastError());
    }
  }
  return with_padded_head_dim(D, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    attn_bwd_delta_kernel<T, kP><<<delta_blocks, 256, 0, stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, S, H, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    if constexpr (kIsBf16<T>) {
      return attn90::launch_bwd_sm90<kP>(q, k, v, key_bias, lse, dout, delta, dq, dk, dv, db,
                                         B, S, H, D, scale, drop, stream);
    } else if constexpr (kP > kTiledMaxHeadDim) {
      return int(cudaErrorInvalidValue);  // taken by the row kernels above
    } else {
      const float* qt = static_cast<const float*>(q);
      const float* kt = static_cast<const float*>(k);
      const float* vt = static_cast<const float*>(v);
      const float* dot = static_cast<const float*>(dout);
      constexpr size_t smem = bwd_smem_bytes<kP>();
      const dim3 grid((S + kTile - 1) / kTile, H, B);
      e = cudaFuncSetAttribute(attn_bwd_dq_kernel<kP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
      attn_bwd_dq_kernel<kP><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, key_bias, dot, lse, delta, static_cast<float*>(dq), S, H, D, scale, drop);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
      e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<kP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
      attn_bwd_dkdv_kernel<kP><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, key_bias, dot, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), db, S, H, D, scale, drop);
      return int(cudaGetLastError());
    }
  });
}

Dropout make_dropout(int enabled, int s_pad, unsigned threshold, unsigned seed0,
                     unsigned seed1, float keep_scale) {
  return Dropout{enabled, s_pad, threshold, seed0, seed1, keep_scale};
}

}  // namespace
}  // namespace attn
}  // namespace stonkgs

extern "C" int flash_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                                         const float* key_bias, void* out, float* lse,
                                         float* stats, int B, int S, int H, int D, float scale,
                                         int dropout,
                                         int s_pad,
                                         unsigned threshold, unsigned seed0, unsigned seed1,
                                         float keep_scale, void* stream) {
  using namespace stonkgs::attn;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_pad < S) return int(cudaErrorInvalidValue);
  const Dropout drop = make_dropout(dropout, s_pad, threshold, seed0, seed1, keep_scale);
  if (dtype == 0)
    return launch_fwd_f32<true>(q, k, v, key_bias, out, lse, B, S, H, D, scale, drop, st);
  if (dtype == 1 && D > kMaxHeadDim)
    return stonkgs::attn90::launch_fwd_wide_sm90<true>(q, k, v, key_bias, out, lse, stats, B, S,
                                                       H, D, scale, drop, st);
  if (dtype == 1)
    return stonkgs::attn90::launch_fwd_sm90<true>(q, k, v, key_bias, out, lse, B, S, H, D,
                                                  scale, drop, st);
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                                         const float* key_bias, const void* out,
                                         const float* lse, const void* dout, void* dq,
                                         void* dk, void* dv, float* db, float* delta, void* ds,
                                         void* pd, float* dk_carry, float* dv_carry, int B,
                                         int S, int H, int D, int group, int chunk, float scale,
                                         int dropout, int s_pad, unsigned threshold,
                                         unsigned seed0, unsigned seed1, float keep_scale,
                                         void* stream) {
  using namespace stonkgs::attn;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_pad < S) return int(cudaErrorInvalidValue);
  const Dropout drop = make_dropout(dropout, s_pad, threshold, seed0, seed1, keep_scale);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, key_bias, out, lse, dout, dq, dk, dv, db, delta, ds, pd,
                             dk_carry, dv_carry, B, S, H, D, group, chunk, scale, drop, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, key_bias, out, lse, dout, dq, dk, dv, db, delta,
                                     ds, pd, dk_carry, dv_carry, B, S, H, D, group, chunk,
                                     scale, drop, st);
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_attention_train_fwd_wide_calls() { return stonkgs::attn90::wide_calls(); }

extern "C" int flash_attention_train_bwd_wide_calls() {
  return stonkgs::attn90::bwd_wide_calls();
}
