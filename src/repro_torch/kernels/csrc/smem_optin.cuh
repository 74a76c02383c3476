// Once-per-process shared-memory opt-in: a kernel may take all the dynamic
// shared memory a block can opt into (the card's opt-in limit less the
// kernel's static shared memory).  Launchers call this from a function-local
// static, so no launch calls cudaFuncSetAttribute and every launch can run
// inside a CUDA graph capture.
#pragma once

#include <cuda_runtime.h>

namespace pw {

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
