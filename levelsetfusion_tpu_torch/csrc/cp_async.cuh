// cp.async helpers shared by the kernels that stage rows in shared memory
// (csrc/dma_probe.cu, csrc/resample_variants.cu, csrc/stack_bodies.cu):
// 16-byte copies that bypass L1 (.cg), one commit group per step, and a wait
// for every group but the newest.

#pragma once

#include <cuda_runtime.h>

namespace lsf_cp {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace lsf_cp
