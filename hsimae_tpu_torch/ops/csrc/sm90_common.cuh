// Hopper (sm_90a) primitives shared by the port's kernels: mbarriers, bulk
// async copies, an L2 prefetch, named barriers, wgmma fences, commits and
// waits, and the shared-memory descriptors and swizzle of wgmma operands.
//
// Header only; every function is inline in namespace hsimae_sm90. A kernel
// source includes it with `#include "sm90_common.cuh"` (ops/_build.py passes
// -I for csrc/ and hashes the headers a source includes into its library's
// name, so an edit here rebuilds the kernels that include it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hsimae_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------- mbarriers ---------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// ------------------------------- copies ------------------------------------

// Global -> shared bulk copy into this CTA; completion counted in bytes on
// the mbarrier. dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Hint that the 128-byte line at p will be read soon: fetch it into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// --------------------------- barriers, fences ------------------------------

// Named barrier `id` over `count` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Makes this thread's generic-proxy shared writes visible to the async proxy
// (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --------------------------------- wgmma -----------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed wgmma groups of the warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma issue and
// wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand at shared address
// addr (1024-aligned atom of 8 rows of 128 bytes, plus 32 bytes per bf16 K
// step of 16): LBO 16 B (unused), SBO 1024 B, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of (row, 16-byte chunk `chunk`) in rows of 128 bytes under the
// 128-byte swizzle: the chunk moves to chunk ^ (row % 8).
__device__ __forceinline__ uint32_t sw128_row(int row, int chunk) {
  return row * 128 + (((chunk ^ row) & 7) << 4);
}

// ---------------------------------- bf16 -----------------------------------

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

}  // namespace hsimae_sm90
