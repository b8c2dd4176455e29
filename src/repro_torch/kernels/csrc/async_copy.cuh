// cp.async (sm_80+) helpers shared by K1's warp-per-tile kernel
// (sinkhorn_fused.cu), K2's stacked-query kernel (rwmd_min_cdist.cu) and
// the ring of K2s and K3 (cdist_ring.cuh): copies from device memory into
// shared memory that run beside the threads' arithmetic, grouped and
// waited on per thread.
#pragma once

#include <cuda_runtime.h>

namespace async_copy {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only; `src_bytes` < 16 zero-fills the rest (0
// reads nothing and writes 16 zero bytes). dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes; `src_bytes` 0 writes a zero.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace async_copy
