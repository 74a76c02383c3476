// Once-per-device shared-memory opt-in: a kernel may take all the dynamic
// shared memory a block can opt into (the card's opt-in limit less the
// kernel's static shared memory).  The attribute is the current device's,
// so launchers set it through once_per_device, which runs it the first time
// each device is current: no later launch calls cudaFuncSetAttribute, every
// launch can run inside a CUDA graph capture, and a process that launches
// on several devices sets it on each.
#pragma once

#include <cuda_runtime.h>

namespace pw {

constexpr int kMaxDevices = 64;

// Runs set() (a cudaError_t as int) the first time the current device is
// seen, keeps its result in done[device] (+1, so 0 is "not yet"), and
// returns the current device's result.
template <typename Set>
inline int once_per_device(int (&done)[kMaxDevices], Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done[dev] == 0) done[dev] = set() + 1;
  return done[dev] - 1;
}

template <typename Kernel>
inline int allow_max_dynamic_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  }
  return (int)err;
}

}  // namespace pw
