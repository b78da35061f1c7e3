// Plain PTX wrappers for Hopper's asynchronous machinery (CUDA C++ for
// sm_90a; included, not built on its own): mbarriers, TMA tile loads and
// wgmma. Used by csrc/knn_tc.cuh. No CUTLASS, so a library
// that includes it builds in seconds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dgcnn {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (all in shared memory, addressed by their 32-bit shared
// address)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to the
// async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of transactions (a TMA load's)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits until the phase of parity `parity` has completed. A wait that has
// not ended after 2^34 clocks (about 10 s) is a fault of the kernel: it
// traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ---- TMA: one thread loads a box of a 3-d tensor map into shared memory;
// completion is counted in bytes on `bar`. Coordinates are in elements,
// innermost first; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma (a warpgroup: four consecutive warps, 128 threads)

// The shared-memory descriptor of a K-major operand in the 32-byte swizzle
// (each row's 16 bf16 of one k-step in 32 bytes, rows 32 bytes apart, 8-row
// groups 256 bytes apart; the region 256-byte aligned): start address,
// leading byte offset 1 (unused by swizzled K-major layouts), stride byte
// offset 256 B, layout type 3 (B32). Offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define DGCNN_ACC4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])

// d += a b for one k-step of 16 channels: a 64 x 16 (the warpgroup's query
// rows), b 16 x 64 (64 keys), both K-major bf16 in shared memory, fp32
// accumulators. d[n][e] holds what mma.sync.m16n8k16's fragment n would:
// rows 16 (warp % 4) + lane / 4 (+ 8 for e >= 2), keys 8 n + 2 (lane % 4)
// (+ 1 for odd e). scale-d is 1: d is added to, as mma.sync adds its C.
__device__ __forceinline__ void wgmma_k16(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : DGCNN_ACC4(0), DGCNN_ACC4(1), DGCNN_ACC4(2), DGCNN_ACC4(3), DGCNN_ACC4(4),
        DGCNN_ACC4(5), DGCNN_ACC4(6), DGCNN_ACC4(7)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef DGCNN_ACC4

}  // namespace sm90
}  // namespace dgcnn
