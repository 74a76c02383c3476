// walk_step: one bulk advance of every random-walk cursor.
//
// Replaces the Pallas TPU kernel `walk_step`
// (src/repro/kernels/walk_step.py:63, body `_walk_step_kernel` :49) and
// the degree/offset gathers its launcher ran outside the kernel.
//
// Per walk (one thread): deg = out_deg[cur], start = row_ptr[cur],
// off = clip(floor(u * deg), 0, deg - 1), next = deg == 0 ? source :
// col_idx[clip(start + off, 0, m - 1)] -- bit-exact with
// walks.sample_edge_offsets (IEEE f32 multiply, no fast math).
//
// Walks sit in rows of `per` walks that share one source: walk i jumps
// home to src[i / per] (per = 1: a source per walk).
//
// Bound: bytes -- 12 B of walk state in/out per walk plus three dependent
// random 4 B gathers (out_deg, row_ptr, col_idx) that each touch a 32 B
// sector.  Design: one thread per walk and nothing else, so the card keeps
// as many independent gathers in flight as it has threads; cursors, u and
// the output are read and written coalesced.
#include <cuda_runtime.h>

extern "C" __global__ void walk_step_kernel(
    const int* __restrict__ cur, const int* __restrict__ src,
    const float* __restrict__ u, const int* __restrict__ row_ptr,
    const int* __restrict__ out_deg, const int* __restrict__ col_idx,
    int* __restrict__ out, long long w, long long per, int m) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  int c = cur[i];
  int deg = out_deg[c];
  if (deg == 0) {
    out[i] = src[i / per];
    return;
  }
  int off = (int)floorf(__fmul_rn(u[i], (float)deg));
  off = min(max(off, 0), deg - 1);
  long long addr = (long long)row_ptr[c] + off;
  addr = addr < 0 ? 0 : (addr > m - 1 ? m - 1 : addr);
  out[i] = col_idx[addr];
}

extern "C" int walk_step_launch(const void* cur, const void* src,
                                const void* u, const void* row_ptr,
                                const void* out_deg, const void* col_idx,
                                void* out, long long w, long long per, int m,
                                void* stream) {
  if (w <= 0) return 0;
  const int threads = 256;
  long long blocks = (w + threads - 1) / threads;
  walk_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cur, (const int*)src, (const float*)u, (const int*)row_ptr,
      (const int*)out_deg, (const int*)col_idx, (int*)out, w, per, m);
  return (int)cudaGetLastError();
}
