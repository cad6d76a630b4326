// Hopper building blocks of K6's wgmma path (int8_conv.cu): mbarriers,
// cp.async completion on an mbarrier, a 2-D TMA tile load, the
// async-proxy fence, and the s8 warpgroup product m64n64k32 with both
// operands in shared memory.  sm_90a only (wgmma does not exist on
// sm_90).
//
// Shared-memory operand layout (the one TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B): a tile of R rows of 128 K-contiguous bytes,
// its base 1024-byte aligned; row r at r * 128, its 16-byte chunk c at
// chunk (c ^ (r % 8)).  The matrix descriptor of such a tile (K-major,
// 128-byte swizzle) has the stride between 8-row groups (SBO) 1024 bytes;
// the leading offset is not used by a swizzled K-major layout.  A k32
// step inside the 128-byte row advances the start address by 32 bytes:
// the hardware applies the swizzle to the address bits, so the step is
// the same for every row.
//
// s32 accumulator of m64nN (per thread of the warpgroup, warp w = its
// warp in the group, g = lane / 4, t = lane % 4): d[4j + 2h + e] is
// (row 16w + g + 8h, column 8j + 2t + e), j < N / 8.

#pragma once

#include <cuda.h>

#include "mma.cuh"

namespace {

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one arrival that also expects `bytes` of asynchronous (TMA) traffic
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival once every cp.async this thread has issued so far has
// landed (.noinc: the arrival is one of the barrier's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// ---- TMA -------------------------------------------------------------------

// the (c0, c1) box of a 2-D tensor map into shared memory; completion is
// counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes (cp.async's) made visible to the async proxy that
// wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// K-major, 128-byte-swizzled matrix descriptor of the tile at `smem`
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint64_t addr = smem_addr(smem);
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void fence_operands(int* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (m64n64, s32) += A (m64k32, s8) . B (n64k32, s8)^T, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n64k32_s8(int* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace
