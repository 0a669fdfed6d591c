// Kernel function attributes set once per (kernel instantiation, device).
// CUDA function attributes belong to each device's context, so a flag per
// process would leave a second card's first launch without them. Included
// by tugemm_mainloop.cuh and flash_paged.cu; kernels/build.py hashes this
// header into the library name of every source that includes it.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace launch_attrs {

constexpr int MAX_DEVICES = 64;

// One per kernel instantiation (a function-local static of its launcher):
// the largest dynamic shared memory allowed on each device so far, 0 = none.
struct Cache {
  std::atomic<int> smem[MAX_DEVICES] = {};
  std::mutex mu;
};

// Allows `kern` `smem` bytes of dynamic shared memory on the current device
// (and cluster sizes above 8 where `nonportable_cluster`), unless a launch
// on that device already set as much; thread-safe. Returns the first
// cudaError_t of cudaGetDevice or cudaFuncSetAttribute, and records nothing
// then, so the next launch tries again and no launch runs without them.
template <typename F>
cudaError_t allow(Cache& c, F* kern, int smem, bool nonportable_cluster) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (c.smem[dev].load(std::memory_order_acquire) >= smem) return cudaSuccess;
  std::lock_guard<std::mutex> lock(c.mu);
  if (c.smem[dev].load(std::memory_order_relaxed) >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && nonportable_cluster)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  c.smem[dev].store(smem, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace launch_attrs
