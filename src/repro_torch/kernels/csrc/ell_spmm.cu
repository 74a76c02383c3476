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
// below the card's rate.  What costs is the gather of f[:, nbr] for each
// ELL entry, and most of those columns are zero: a batch's first push
// starts from one-hot rows (at most Q live columns of n), and later pushes
// of a sparse-route graph stay far from dense.  Design:
//   1. `compact_columns_kernel`, the only full read of f: a block owns 32
//      vertices, reads their columns row by row (a warp reads 128 B of a
//      row), marks each vertex whose column holds a non-zero, gives it a
//      slot (one atomicAdd per block on a running count, so no host read)
//      or -1, and writes only the live columns, transposed, into ftc
//      [slot, Q] (the second read of the block's columns hits L2);
//   2. `ell_pull_kernel`: a block owns kRows consecutive ELL rows and kQ
//      columns q (one per thread).  It stages its rows' live entries
//      (w != 0 and slot[nbr] >= 0) in shared memory, compacted in row
//      order, and each thread then walks its rows in order, gathering an
//      ftc row (kQ contiguous floats across the block) only for a live
//      entry, and sums each vertex's run of rows in registers.
//      A vertex whose rows all lie in the block goes to a shared-memory
//      tile, and the block then writes every vertex it owns (those whose
//      rows start in it, and the vertices without in-edges in between, as
//      0) row-major with neighbouring threads on neighbouring vertices.  A
//      vertex whose rows cross a block boundary (a hub) leaves one partial
//      sum per block in `carry`: slot 1 for the block its rows start in,
//      slot 0 for the blocks it continues into;
//   3. `ell_fold_kernel` adds each crossing vertex's partials in block
//      order.
// Every sum runs in a fixed order (rows in order, entries in order, blocks
// in order), whatever the degree skew and whichever slots the atomics
// hand out.  A skipped entry is a padding slot (w == 0) or a column that
// is zero for every q: fma(w, 0, acc) == acc for a finite acc, so
// skipping it keeps each sum's bits.
#include "compact.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kRows = 32;      // ELL rows per block
constexpr int kQ = 128;        // query columns per block (one per thread)
constexpr int kCols = 32;      // vertices per block of the column pass
constexpr int kColRows = 8;    // thread rows of the column pass

__global__ void __launch_bounds__(kCols * kColRows)
compact_columns_kernel(const float* __restrict__ f, int q, int n,
                       int* __restrict__ slot, float* __restrict__ ftc,
                       int* __restrict__ n_live) {
  __shared__ float tile[kCols][kCols + 1];
  __shared__ int nz[kColRows][kCols];
  __shared__ int sslot[kCols];
  __shared__ int any_live;
  const int x = threadIdx.x, y = threadIdx.y;
  const long long v = (long long)blockIdx.x * kCols + x;
  bool live = false;
  if (v < n)
    for (long long r = y; r < q; r += kColRows) live |= f[r * n + v] != 0.0f;
  nz[y][x] = live;
  __syncthreads();
  if (y == 0) {  // warp 0: one lane per vertex
    bool any = false;
    for (int j = 0; j < kColRows; ++j) any |= nz[j][x] != 0;
    unsigned ballot = __ballot_sync(0xffffffffu, any);
    int base = 0;
    if (x == 0 && ballot) base = atomicAdd(n_live, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    int s = any ? base + __popc(ballot & ((1u << x) - 1u)) : -1;
    if (v < n) slot[v] = s;
    sslot[x] = s;
    if (x == 0) any_live = ballot != 0;
  }
  __syncthreads();
  if (!any_live) return;
  for (long long r0 = 0; r0 < q; r0 += kCols) {
    for (int j = y; j < kCols; j += kColRows) {
      long long r = r0 + j;
      if (r < q && v < n) tile[j][x] = f[r * n + v];
    }
    __syncthreads();
    for (int j = y; j < kCols; j += kColRows) {
      int s = sslot[j];
      long long r = r0 + x;
      if (s >= 0 && r < q) ftc[(long long)s * q + r] = tile[x][j];
    }
    __syncthreads();
  }
}

// Dynamic shared memory: the block's live entries (slot, weight) in row
// order, kRows * k of each at most, then kRows + 1 row starts.
__global__ void __launch_bounds__(kQ)
ell_pull_kernel(const float* __restrict__ ftc, const int* __restrict__ slot,
                const int* __restrict__ nbr, const float* __restrict__ w,
                const int* __restrict__ row2vertex,
                const int* __restrict__ vertex_rows, int q, int n_out,
                int rows, int k, float* __restrict__ out,
                float* __restrict__ carry, int n_blocks) {
  __shared__ float res[kRows][kQ + 1];
  __shared__ int red[32];
  __shared__ int rv[kRows], rs_of[kRows], re_of[kRows];  // row -> vertex
  extern __shared__ int stage[];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int r0 = b * kRows;
  const int r1 = min(r0 + kRows, rows);
  int* cs = stage;                                   // [kRows * k]
  float* cw = reinterpret_cast<float*>(stage + kRows * k);
  int* row_at = stage + 2 * kRows * k;               // [kRows + 1]

  // stage each row's vertex and its row range, and the live entries,
  // compacted in row order
  if (t < r1 - r0) {
    const int v = row2vertex[r0 + t];
    rv[t] = v;
    rs_of[t] = vertex_rows[v];
    re_of[t] = vertex_rows[v + 1];
  }
  const int ne = (r1 - r0) * k;
  const long long e_base = (long long)r0 * k;
  int before = 0;
  for (int e0 = 0; e0 < ne; e0 += kQ) {
    const int e = e0 + t;
    int s = -1;
    float wt = 0.0f;
    if (e < ne) {
      wt = __ldg(w + e_base + e);
      if (wt != 0.0f) s = __ldg(slot + __ldg(nbr + e_base + e));
    }
    int total;
    const int at = pw::block_rank(s >= 0, red, &total);
    if (s >= 0) {
      cs[before + at] = s;
      cw[before + at] = wt;
    }
    if (e < ne && e % k == 0) row_at[e / k] = before + at;
    before += total;
  }
  if (t == 0) row_at[r1 - r0] = before;
  __syncthreads();

  // the block owns the vertices from the one after the last row before it
  // to the one of its own last row (the first vertex with vertex_rows >=
  // r0, and >= r1), the vertices without in-edges between them included
  const int own0 = b == 0 ? 0 : row2vertex[r0 - 1] + 1;
  const int own1 = b + 1 == n_blocks ? n_out : rv[r1 - 1 - r0] + 1;
  const int lane = t & 31, warp = t >> 5;

  const int qi = blockIdx.y * kQ + t;
  const bool live = qi < q;
  float acc = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const int i1 = row_at[r - r0 + 1];
    if (live)
      for (int i = row_at[r - r0]; i < i1; ++i)
        acc = __fmaf_rn(cw[i], __ldg(ftc + (long long)cs[i] * q + qi), acc);
    const int i = r - r0;
    if (r + 1 < r1 && rv[i + 1] == rv[i]) continue;  // run goes on
    const int rs = rs_of[i], re = re_of[i];
    if (rs >= r0 && re <= r1) {
      res[rs - r0][t] = acc;
    } else if (live) {
      const int cslot = rs < r0 ? 0 : 1;
      carry[((long long)cslot * n_blocks + b) * q + qi] = acc;
    }
    acc = 0.0f;
  }
  __syncthreads();
  for (int vb = own0; vb < own1; vb += 32) {
    const int v = vb + lane;
    int kind = 0;  // 0: not written here, 1: zero, 2: from the tile
    int rs = 0;
    if (v < own1) {
      rs = vertex_rows[v];
      const int re = vertex_rows[v + 1];
      kind = rs == re ? 1 : (re <= r1 ? 2 : 0);
    }
    for (int j = warp; j < kQ; j += kQ / 32) {
      const int qo = blockIdx.y * kQ + j;
      if (kind && qo < q)  // streaming: out is not read again here
        __stcs(out + (long long)qo * n_out + v,
               kind == 1 ? 0.0f : res[rs - r0][j]);
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

// Bytes of dynamic shared memory the pull needs at ELL width k.
extern "C" int ell_spmm_stage_bytes(int k) {
  return (2 * kRows * k + kRows + 1) * (int)sizeof(int);
}

// f [q, n_in] -> out [q, n_out]; slot [n_in], ftc [n_in, q], carry [2,
// n_blocks, q] and n_live [1] (zeroed here) are wrapper scratch.  rows is
// the count of ELL rows in use (padding rows past it are never read);
// n_blocks = max(1, ceil(rows / kRows)).
extern "C" int ell_spmm_launch(const void* f, const void* nbr, const void* w,
                               const void* row2vertex,
                               const void* vertex_rows, int q, int n_in,
                               int n_out, int rows, int k, void* slot,
                               void* ftc, void* n_live, void* carry,
                               int n_blocks, void* out, void* stream) {
  if (q <= 0 || n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(n_live, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0 && n_in > 0) {
    dim3 tb(kCols, kColRows), tg((n_in + kCols - 1) / kCols);
    compact_columns_kernel<<<tg, tb, 0, s>>>((const float*)f, q, n_in,
                                             (int*)slot, (float*)ftc,
                                             (int*)n_live);
  }
  static int smem_done[pw::kMaxDevices];
  const int smem_err = pw::once_per_device(
      smem_done, [] { return pw::allow_max_dynamic_smem(ell_pull_kernel); });
  if (smem_err) return smem_err;
  const int smem = ell_spmm_stage_bytes(rows > 0 ? k : 0);
  const dim3 grid(n_blocks, (q + kQ - 1) / kQ);
  ell_pull_kernel<<<grid, kQ, smem, s>>>(
      (const float*)ftc, (const int*)slot, (const int*)nbr, (const float*)w,
      (const int*)row2vertex, (const int*)vertex_rows, q, n_out, rows, k,
      (float*)out, (float*)carry, n_blocks);
  if (n_blocks > 1)
    ell_fold_kernel<<<grid, kQ, 0, s>>>(
        (const int*)row2vertex, (const int*)vertex_rows, q, n_out, rows,
        (float*)out, (const float*)carry, n_blocks);
  return (int)cudaGetLastError();
}
