// hbm-residency violations: a push whose block holds a dense row of the
// runtime vertex count n in shared memory, a gather that stages the CSR
// into dynamic shared memory of bytes that grow with the edge count, and
// a kernel that writes the operand it should only gather from.
#include <cuda_runtime.h>

constexpr int kThreads = 256;

extern "C" __global__ void dense_row_kernel(const int* __restrict__ col_idx,
                                            int n, float* out) {
  __shared__ float row[n];                           // [viol:runtime-extent]
  for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = 0.0f;
  __syncthreads();
  out[blockIdx.x] = row[col_idx[blockIdx.x] % n];
}

extern "C" __global__ void staged_gather_kernel(int* col_idx, int m,  // [viol:writable]
                                                int* out) {
  extern __shared__ int staged[];
  for (int i = threadIdx.x; i < m; i += blockDim.x) staged[i] = col_idx[i];
  __syncthreads();
  col_idx[blockIdx.x] = staged[blockIdx.x % m];
  out[blockIdx.x] = staged[0];
}

extern "C" int bad_launch(const void* col_idx, int n, int m, void* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dense_row_kernel<<<1, kThreads, 0, s>>>((const int*)col_idx, n,
                                          (float*)out);
  const int bytes = 4 * m;
  staged_gather_kernel<<<1, kThreads, bytes, s>>>(  // [viol:dynamic-bytes]
      (int*)col_idx, m, (int*)out);
  return (int)cudaGetLastError();
}
