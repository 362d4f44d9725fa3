// One-wave grids: how many CTAs of a kernel the current device holds at once,
// from the CUDA occupancy API. A kernel's dynamic shared memory opt-in and its
// occupancy belong to a device, so both are asked for once per device ordinal
// (cudaGetDevice), not once per process: a process that launches on a second
// GPU sets the opt-in there too.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace lsf_occ {

constexpr int kMaxDevices = 64;  // ordinals past this are asked at every call

// One per kernel instantiation, with static storage (so zero-initialised).
struct WaveCache {
  std::atomic<int> ctas[kMaxDevices];
};

// Sets `kernel`'s dynamic shared memory limit to `smem` bytes on the current
// device and returns the CTAs of `threads` threads that its SMs hold at once
// (at least one per SM); -1 if the CUDA runtime refused a call.
inline int wave(const void* kernel, int threads, int smem, WaveCache& cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    const int known = cache.ctas[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  const int ctas = sms * (per_sm > 0 ? per_sm : 1);
  if (cached) cache.ctas[dev].store(ctas, std::memory_order_relaxed);
  return ctas;
}

}  // namespace lsf_occ
