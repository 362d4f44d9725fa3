// cp.async helpers shared by the kernels that stage rows in shared memory
// (csrc/dma_probe.cu, csrc/resample_variants.cu, csrc/stack_bodies.cu,
// csrc/fused_gradient.cu): 16-byte copies that bypass L1 (.cg), 16- and
// 4-byte copies that can write zeros instead of reading, one commit group
// per step, and a wait for every group but the newest N.

#pragma once

#include <cuda_runtime.h>

namespace lsf_cp {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src)
               : "memory");
}

// 16 bytes; with `read` false nothing is read (`src` must still be a valid
// address) and the destination gets zeros.
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool read) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned bytes = read ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(bytes)
               : "memory");
}

// One float; with `read` false nothing is read (`src` must still be a valid
// address) and the destination gets 0.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool read) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned bytes = read ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every group but the newest N.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace lsf_cp
