// index_combine (dense): the final VERD combine of the dense route
// (paper Algorithm 4 line 10) on [Q, n] state,
//
//   out[q, :] = s[q, :] + sum_v f[q, v] * scatter(vals[v, :] at idx[v, :])
//
// Replaces the Pallas TPU kernel `index_combine`
// (src/repro/kernels/index_combine.py:52, body `_index_combine_kernel`
// :30), the kernel twin of `verd.combine_with_index`
// (src/repro/core/verd.py:126).
//
// Bound: bytes -- s and f read once, out written once (3 * Q * n * 4 B),
// plus the index rows that a nonzero f[q, v] touches (8 B per entry).
// The TPU kernel walks every (q, v) pair: Q * n * L scatter-adds, 6.9e10
// at rmat(20), Q = L = 256.  After t = 2 pushes a row of f holds ~5k
// nonzeros of 2^20, so the design skips the zeros, which is exact:
// s + 0 * x is s for finite x.
//   1. `copy_kernel` initialises out = s (16 B per thread);
//   2. `scatter_kernel`: a block takes kCols consecutive vertices of one
//      query row; each warp reads 32 f values at a time (one 128 B line),
//      ballots the nonzeros, and for each of them reads the vertex's
//      index row with neighbouring lanes on neighbouring entries and
//      atomically adds f * vals into out[q, idx].  Blocks run row-major, so
//      the blocks in flight share a few output rows (4 MB each) and the
//      atomics stay in L2.  Zero index entries (row padding) and columns
//      outside [0, n) are skipped, as the reference's scatter drops them.
// The atomics make the summation order of colliding columns vary from run
// to run: on dyadic inputs every order gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 2048;    // vertices of f per block

__global__ void copy_kernel(const float4* __restrict__ s,
                            float4* __restrict__ out, long long n4) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n4; i += stride) out[i] = s[i];
}

__global__ void copy_tail_kernel(const float* __restrict__ s,
                                 float* __restrict__ out, long long from,
                                 long long total) {
  long long i = from + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ f, const float* __restrict__ vals,
               const int* __restrict__ idx, int nv, int n, int l,
               float* __restrict__ out) {
  const long long q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v_end = min((int)((blockIdx.x + 1) * kCols), nv);
  const float* fq = f + q * nv;
  float* oq = out + q * n;
  for (int v0 = blockIdx.x * kCols + warp * 32; v0 < v_end;
       v0 += kThreads) {
    const int v = v0 + lane;
    const float fv = v < v_end ? fq[v] : 0.0f;
    unsigned live = __ballot_sync(0xffffffffu, fv != 0.0f);
    while (live) {
      const int b = __ffs(live) - 1;
      live &= live - 1;
      const float fb = __shfl_sync(0xffffffffu, fv, b);
      const long long row = (long long)(v0 + b) * l;
      for (int j = lane; j < l; j += 32) {
        const float x = __ldg(vals + row + j);
        const int c = __ldg(idx + row + j);
        if (x != 0.0f && (unsigned)c < (unsigned)n)
          atomicAdd(oq + c, fb * x);
      }
    }
  }
}

}  // namespace

// s, out [q, n]; f [q, nv]; vals, idx [nv, l].
extern "C" int index_combine_dense_launch(const void* s, const void* f,
                                          const void* vals, const void* idx,
                                          int q, int n, int nv, int l,
                                          void* out, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)q * n;
  const long long n4 = total / 4;
  if (n4 > 0) {
    long long blocks = (n4 + 255) / 256;
    if (blocks > 65536) blocks = 65536;
    copy_kernel<<<(unsigned)blocks, 256, 0, st>>>((const float4*)s,
                                                  (float4*)out, n4);
  }
  if (total > n4 * 4)
    copy_tail_kernel<<<1, 4, 0, st>>>((const float*)s, (float*)out, n4 * 4,
                                      total);
  if (nv > 0 && l > 0) {
    dim3 grid((nv + kCols - 1) / kCols, q);
    scatter_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)f, (const float*)vals, (const int*)idx, nv, n, l,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
