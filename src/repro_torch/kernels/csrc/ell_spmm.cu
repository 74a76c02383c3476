// ell_spmm: the dense frontier push out = f @ A0 over the row-chunked ELL
// pull view, with each vertex's chunk rows folded inside the kernel.
//
// Replaces the Pallas TPU kernel `ell_spmm`
// (src/repro/kernels/ell_spmm.py:56, body `_ell_spmm_kernel` :38) and the
// row2vertex segment-sum its wrapper `ops.ell_push`
// (src/repro/kernels/ops.py:71) ran outside it:
//
//   out[q, v] = sum over rows r of v, sum_k w[r, k] * f[q, nbr[r, k]]
//
// Bound: bytes.  f is read once (Q * n * 4 B), the ELL once (rows * K * 8
// B) and out written once (Q * n * 4 B); the f32 multiply-adds are far
// below the card's rate.  What costs is the gather: f[q, nbr] along a
// row-major [Q, n] row touches one 4 B word per 32 B sector.  Design:
//   1. `transpose_kernel` writes f^T [n, Q] into wrapper scratch, so the
//      Q values of one in-neighbour are contiguous: a warp reads 32 of them
//      as one 128 B line;
//   2. `ell_pull_kernel`: a block owns kRows consecutive ELL rows and 128
//      columns q (one per thread); each thread walks its rows in order and
//      sums each vertex's run of rows in registers.  A vertex whose rows
//      all lie in the block goes to a shared-memory tile, and the block
//      then writes every vertex it owns (those whose rows start in it, and
//      the vertices without in-edges in between, as 0) row-major with
//      neighbouring threads on neighbouring vertices.  A vertex whose rows
//      cross a block boundary (a hub) leaves one partial sum per block in
//      `carry`: slot 1 for the block its rows start in, slot 0 for the
//      blocks it continues into;
//   3. `ell_fold_kernel` adds each crossing vertex's partials in block
//      order.  Every block has the same row count whatever the degree skew,
//      and every sum runs in a fixed order, so the result is deterministic.
// Padding slots (w == 0) are skipped: adding 0 * f leaves a finite sum as
// it is.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // ELL rows per block
constexpr int kQ = 128;        // query columns per block (one per thread)

__global__ void transpose_kernel(const float* __restrict__ f,
                                 float* __restrict__ ft, int q, int n) {
  __shared__ float tile[32][33];
  long long c0 = (long long)blockIdx.x * 32;  // vertex
  long long r0 = (long long)blockIdx.y * 32;  // query row
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    long long r = r0 + j, c = c0 + threadIdx.x;
    if (r < q && c < n) tile[j][threadIdx.x] = f[r * n + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    long long c = c0 + j, r = r0 + threadIdx.x;
    if (r < q && c < n) ft[c * q + r] = tile[threadIdx.x][j];
  }
}

// smallest v in [0, n] with vertex_rows[v] >= row
__device__ int lower_bound(const int* __restrict__ vertex_rows, int n,
                           int row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (vertex_rows[mid] < row) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kQ)
ell_pull_kernel(const float* __restrict__ ft, const int* __restrict__ nbr,
                const float* __restrict__ w,
                const int* __restrict__ row2vertex,
                const int* __restrict__ vertex_rows, int q, int n_out,
                int rows, int k, float* __restrict__ out,
                float* __restrict__ carry, int n_blocks) {
  __shared__ float res[kRows][kQ + 1];
  __shared__ int owned[2];
  const int b = blockIdx.x;
  const int r0 = b * kRows;
  const int r1 = min(r0 + kRows, rows);
  const int t = threadIdx.x;
  const int qi = blockIdx.y * kQ + t;
  const bool live = qi < q;

  float acc = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const int* nr = nbr + (long long)r * k;
    const float* wr = w + (long long)r * k;
    for (int j = 0; j < k; ++j) {
      float wt = __ldg(wr + j);
      if (wt != 0.0f && live)
        acc = __fmaf_rn(wt, __ldg(ft + (long long)__ldg(nr + j) * q + qi),
                        acc);
    }
    const int v = row2vertex[r];
    if (r + 1 < r1 && row2vertex[r + 1] == v) continue;  // run goes on
    const int rs = vertex_rows[v], re = vertex_rows[v + 1];
    if (rs >= r0 && re <= r1) {
      res[rs - r0][t] = acc;
    } else if (live) {
      int slot = rs < r0 ? 0 : 1;
      carry[((long long)slot * n_blocks + b) * q + qi] = acc;
    }
    acc = 0.0f;
  }

  if (t == 0) {
    owned[0] = b == 0 ? 0 : lower_bound(vertex_rows, n_out, r0);
    owned[1] = b + 1 == n_blocks ? n_out
                                 : lower_bound(vertex_rows, n_out, r1);
  }
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  for (int vb = owned[0]; vb < owned[1]; vb += 32) {
    const int v = vb + lane;
    int kind = 0;  // 0: not written here, 1: zero, 2: from the tile
    int rs = 0;
    if (v < owned[1]) {
      rs = vertex_rows[v];
      const int re = vertex_rows[v + 1];
      kind = rs == re ? 1 : (re <= r1 ? 2 : 0);
    }
    for (int j = warp; j < kQ; j += kQ / 32) {
      const int qo = blockIdx.y * kQ + j;
      if (kind && qo < q)
        out[(long long)qo * n_out + v] = kind == 1 ? 0.0f : res[rs - r0][j];
    }
  }
}

__global__ void __launch_bounds__(kQ)
ell_fold_kernel(const int* __restrict__ row2vertex,
                const int* __restrict__ vertex_rows, int q, int n_out,
                int rows, float* __restrict__ out,
                const float* __restrict__ carry, int n_blocks) {
  const int b = blockIdx.x;
  const int r0 = b * kRows;
  const int r1 = min(r0 + kRows, rows);
  const int qi = blockIdx.y * kQ + threadIdx.x;
  if (r1 <= r0 || qi >= q) return;
  const int v = row2vertex[r1 - 1];
  const int rs = vertex_rows[v], re = vertex_rows[v + 1];
  if (rs < r0 || re <= r1) return;  // no crossing vertex starts here
  float acc = carry[((long long)n_blocks + b) * q + qi];
  for (int bb = b + 1; bb * kRows < re; ++bb)
    acc += carry[(long long)bb * q + qi];
  out[(long long)qi * n_out + v] = acc;
}

}  // namespace

extern "C" int ell_spmm_rows_per_block() { return kRows; }

// f [q, n_in] -> out [q, n_out]; ft [n_in, q] and carry [2, n_blocks, q]
// are wrapper scratch.  rows is the count of ELL rows in use (padding rows
// past it are never read); n_blocks = max(1, ceil(rows / kRows)).
extern "C" int ell_spmm_launch(const void* f, const void* nbr, const void* w,
                               const void* row2vertex,
                               const void* vertex_rows, int q, int n_in,
                               int n_out, int rows, int k, void* ft,
                               void* carry, int n_blocks, void* out,
                               void* stream) {
  if (q <= 0 || n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0 && n_in > 0) {
    dim3 tb(32, 8), tg((n_in + 31) / 32, (q + 31) / 32);
    transpose_kernel<<<tg, tb, 0, s>>>((const float*)f, (float*)ft, q, n_in);
  }
  dim3 grid(n_blocks, (q + kQ - 1) / kQ);
  ell_pull_kernel<<<grid, kQ, 0, s>>>(
      (const float*)ft, (const int*)nbr, (const float*)w,
      (const int*)row2vertex, (const int*)vertex_rows, q, n_out, rows, k,
      (float*)out, (float*)carry, n_blocks);
  if (n_blocks > 1)
    ell_fold_kernel<<<grid, kQ, 0, s>>>(
        (const int*)row2vertex, (const int*)vertex_rows, q, n_out, rows,
        (float*)out, (const float*)carry, n_blocks);
  return (int)cudaGetLastError();
}
