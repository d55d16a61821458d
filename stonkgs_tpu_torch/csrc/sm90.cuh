// Hopper (sm_90a) building blocks shared by the port's wgmma kernels
// (attention_sm90.cuh, attention_wide_sm90.cuh, attention_bwd_sm90.cuh,
// attention_bwd_wide_sm90.cuh, bigbird_sm90.cuh, bigbird_wide_sm90.cuh,
// ffn_sm90.cuh, ffn_train_sm90.cuh, int8_sm90.cuh): mbarriers, TMA loads,
// stores and reduce-adds, wgmma
// shared-memory descriptors and the wgmma instructions (bf16 and s8), the
// accumulator's register map, and the driver's tensor-map encoder.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the driver is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace stonkgs {
namespace sm90 {

using bf16 = __nv_bfloat16;

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// expect `bytes` more of TMA on the barrier's current phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase with the given parity has completed; a
// wait far longer than any tile load (a fault in the ring's protocol)
// traps, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the 1024-byte aligned shared-memory layout in a kernel's dynamic shared
// memory (the 128-byte swizzle repeats every 8 lines, and the wgmma
// descriptors assume base offset 0; the launch adds 1024 bytes of slack)
template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// a consumer warp's arrival on a ring stage's empty barrier, once all its
// lanes are done with the stage
__device__ __forceinline__ void release_stage(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// --- TMA --------------------------------------------------------------------

// a box at (c0, c1) of a 2-D map -> shared, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a box at (c0, c1, c2) of a 3-D map -> shared, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// a box at (c0, c1, c2, c3) of a 4-D map -> shared, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// a 2-D box of shared memory -> a map at (c0, c1), in this thread's bulk
// group; rows and columns outside the map are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// close this thread's bulk group of TMA stores
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's committed TMA stores have read their shared
// memory (which may then be reused or freed)
__device__ __forceinline__ void tma_store_read_done() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// commit this thread's TMA stores and wait until they have read their
// shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  tma_store_commit();
  tma_store_read_done();
}

// wait until this thread's committed TMA stores and reduce-adds are done
__device__ __forceinline__ void tma_store_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a box of shared memory added into a map at (c0, c1, c2, c3) (the adds
// run in L2, element by element in the map's type), in this thread's bulk
// group; rows and columns outside the map are not written
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// make this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads (whole warps); id 0 is __syncthreads'
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// byte offset of byte `b` (< 128) of line `row` in a box of 128-byte
// lines with the 128-byte swizzle (TMA's and wgmma's layout: the 16-byte
// chunk index is XORed with the line's index mod 8; the box is 1024-byte
// aligned)
__device__ __forceinline__ uint32_t sw128_byte(int row, int b) {
  return uint32_t(row) * 128 + ((uint32_t((b >> 4) ^ row) & 7) << 4) + uint32_t(b & 15);
}

// byte offset of bf16 element (row, col < 64) in such a box
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return sw128_byte(row, col * 2);
}

// --- wgmma ------------------------------------------------------------------

// wgmma shared-memory descriptor of a tile of kLine-byte lines (kLine 128,
// 64 or 32) with the swizzle of that width, as TMA writes it: the 16-byte
// chunk index within a line is XORed with the line's index (mod 8, 4 or
// 2), and the pattern repeats every 8 lines, so tiles are aligned to 8
// lines (1024, 512 or 256 bytes) and the base offset is 0.  Fields: start
// address, the leading offset `lbo` in bytes, the stride of 8 * kLine
// bytes between 8-line groups, and the layout type (128 B: 1, 64 B: 2,
// 32 B: 3).  K-major operands ignore the leading offset; an MN-major
// operand wider than a line (a (K, N) row-major weight tile of N > 64 at
// kLine 128, stored as N/64 separate 64-wide column blocks of K lines
// each) steps by it from one column block to the next.  A K-major operand
// advances by 32 bytes (2 units) a k16 step within its line; an MN-major
// one by 16 lines.
template <int kLine>
__device__ __forceinline__ uint64_t desc_sw(const void* tile, uint32_t lbo = 8 * kLine) {
  static_assert(kLine == 128 || kLine == 64 || kLine == 32, "a swizzle of 128, 64 or 32 bytes");
  constexpr uint64_t kLayout = kLine == 128 ? 1 : kLine == 64 ? 2 : 3;
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((8 * kLine) >> 4) << 32) | (kLayout << 62);
}

// the 128-byte case (a line is 64 bf16)
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo = 1024) {
  return desc_sw<128>(tile, lbo);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define STONKGS_ACC8(d, i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define STONKGS_ACC32(d, i) \
  STONKGS_ACC8(d, i), STONKGS_ACC8(d, i + 8), STONKGS_ACC8(d, i + 16), STONKGS_ACC8(d, i + 24)

// d (64 x 128, fp32) (+)= A (64 x 16, desc) . B (16 x 128, desc): A
// K-major (kTnspA 0) or M-major (1: 16 lines of K, each 64 values of M);
// B K-major (kTnspB 0: 128 lines of K, read as B^T) or MN-major (1: two
// 64-wide column blocks `lbo` bytes apart); acc = 0 overwrites d
template <int kTnspB, int kTnspA = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : STONKGS_ACC32(d, 0), STONKGS_ACC32(d, 32)
      : "l"(da), "l"(db), "r"(acc), "n"(kTnspA), "n"(kTnspB));
}

// d (64 x 128, fp32) (+)= A (64 x 16, desc) . B^T (B 128 x 16, desc), both
// K-major; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_n128<0>(d, da, db, acc);
}

// d (64 x N, fp32) (+)= A (64 x 16, desc) . B (16 x N, desc), both from
// shared memory, N = 2R for R = 32, 16 or 8 accumulator registers (N =
// 64, 32 or 16): A K-major (kTnspA 0) or M-major (1: 16 lines of K, each
// 64 values of M, as an MN-major B), B K-major (kTnspB 0: N lines of K,
// read as B^T) or N-major (1: 16 lines of K, each N values, one line of
// a tile at a swizzle of 2N bytes); acc = 0 overwrites d
template <int R, int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  static_assert(R == 32 || R == 16 || R == 8, "wgmma_ss takes N = 64, 32 or 16");
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : STONKGS_ACC32(d, 0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTnspA), "n"(kTnspB));
  } else if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : STONKGS_ACC8(d, 0), STONKGS_ACC8(d, 8)
        : "l"(da), "l"(db), "r"(acc), "n"(kTnspA), "n"(kTnspB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : STONKGS_ACC8(d, 0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTnspA), "n"(kTnspB));
  }
}

// d (64 x 64, fp32) (+)= A (64 x 16, desc) . B^T (B 64 x 16, desc), both
// K-major; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_qk64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_ss<32, 0, 0>(d, da, db, acc);
}

// d (64 x N, fp32) += A (64 x 16 bf16, registers) . B (16 x N, desc,
// MN-major), N = 2R for R = 32, 16 or 8 accumulator registers (N = 64,
// 32 or 16: one line of B's tile at a swizzle of 128, 64 or 32 bytes)
template <int R>
__device__ __forceinline__ void wgmma_pv(float (&d)[R], const uint32_t* a, uint64_t db) {
  static_assert(R == 32 || R == 16 || R == 8, "wgmma_pv takes N = 64, 32 or 16");
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : STONKGS_ACC32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : STONKGS_ACC8(d, 0), STONKGS_ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : STONKGS_ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// Registers kOff .. kOff + 31 of a wider accumulator d (64 x 2N, fp32),
// its columns 2kOff .. 2kOff + 63, += A (64 x 16 bf16, registers) . B
// (16 x 64, desc, MN-major, one line of B's tile at the 128-byte swizzle).  Two such
// products at kOff 0 and 32 fill a 64 x 128 accumulator, register for
// register as wgmma.m64n128k16 would (acc_col), with B's two 64-wide
// column blocks apart.
template <int kOff, int N>
__device__ __forceinline__ void wgmma_pv_at(float (&d)[N], const uint32_t* a, uint64_t db) {
  static_assert(kOff % 32 == 0 && kOff + 32 <= N, "a 64-wide block of the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : STONKGS_ACC32(d, kOff)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, desc, K-major) . B (16 x 256, desc):
// B MN-major (kTnspB 1: four 64-wide column blocks `lbo` bytes apart) or
// K-major (0: 256 lines of K, read as B^T)
template <int kTnspB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : STONKGS_ACC32(d, 0), STONKGS_ACC32(d, 32), STONKGS_ACC32(d, 64), STONKGS_ACC32(d, 96)
      : "l"(da), "l"(db), "r"(1), "n"(kTnspB));
}

#define STONKGS_IACC8(d, i)                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define STONKGS_IACC32(d, i) \
  STONKGS_IACC8(d, i), STONKGS_IACC8(d, i + 8), STONKGS_IACC8(d, i + 16), STONKGS_IACC8(d, i + 24)

// d (64 x 128, s32) += A (64 x 32 s8, desc) . B^T (B 128 x 32 s8, desc),
// both K-major (the only layout wgmma takes for 8-bit operands); one k32
// step is 32 bytes, as a bf16 k16 step, so desc_sw128 and its 2-unit
// advance serve unchanged
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : STONKGS_IACC32(d, 0), STONKGS_IACC32(d, 32)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, s32) += A (64 x 32 s8, desc) . B^T (B 256 x 32 s8, desc), both K-major
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : STONKGS_IACC32(d, 0), STONKGS_IACC32(d, 32), STONKGS_IACC32(d, 64), STONKGS_IACC32(d, 96)
      : "l"(da), "l"(db), "r"(1));
}

#undef STONKGS_IACC32
#undef STONKGS_IACC8
#undef STONKGS_ACC32
#undef STONKGS_ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator layout of a wgmma with M = 64 (PTX ISA, wgmma D
// fragments): in warp w of the warpgroup, lane l, register i holds
//   row 16w + l/4 + 8*((i/2) % 2),  column 8*(i/4) + 2*(l%4) + i%2.
// A register pair (2j, 2j+1), packed to bf16x2, is also one register of
// the A fragment of a product whose A operand comes from registers
// (columns 16kk.. of the accumulator are that product's k-step kk).
__device__ __forceinline__ int acc_row(int i) { return (i >> 1) & 1; }  // + l/4 + 16w
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// --- host side --------------------------------------------------------------

// returned when a TMA tensor map cannot be encoded (no cudaError_t is negative;
// ops/_build.py names it)
constexpr int kErrTensorMap = -1;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    const bool ok = e == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// the tensor-map data type of each element type
template <typename T> struct MapType;
template <> struct MapType<bf16> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct MapType<int> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_INT32;
};
template <> struct MapType<int8_t> {  // codes move as bytes; wgmma reads them as s8
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// the tensor-map swizzle of a box whose inner extent is `line` bytes
// (128, 64 or 32), which wgmma's descriptor of the same width reads; a row
// wider than 128 bytes is loaded as boxes of 128-byte lines (column blocks)
inline CUtensorMapSwizzle swizzle_of(int line) {
  return line == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : line == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// a tensor map of `type` with the given swizzle (128 bytes by default):
// `rank` dims (innermost first), the byte strides of dims 1.., and the
// box; out-of-range elements of a box read as zero
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, cuuint32_t(rank), const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-D map of a row-major (rows, cols) matrix of T with rows `ld` elements
// apart (ld * sizeof(T) a multiple of 16; cols by default): dims (cols,
// rows), box (box_cols, box_rows), box_cols * sizeof(T) <= 128
template <typename T = bf16>
inline bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                        int box_rows, long long ld = 0) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(ld > 0 ? ld : cols) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  return encode_map(map, MapType<T>::kType, base, 2, dims, strides, box);
}

}  // namespace sm90
}  // namespace stonkgs
