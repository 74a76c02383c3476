// index_combine (dense): the final VERD combine of the dense route
// (paper Algorithm 4 line 10) on [Q, n] state,
//
//   out[q, c] = s[q, c] + sum over (v, j) with idx[v, j] == c of
//               f[q, v] * vals[v, j]
//
// Replaces the Pallas TPU kernel `index_combine`
// (src/repro/kernels/index_combine.py:52, body `_index_combine_kernel`
// :30), the kernel twin of `verd.combine_with_index`
// (src/repro/core/verd.py:126).
//
// Bound: bytes -- s and f read once, out written once (3 * Q * n * 4 B),
// plus the index entries that a nonzero f[q, v] touches (8 B each).  The
// TPU kernel walks every (q, v) pair: Q * n * L scatter-adds, 6.9e10 at
// rmat(20), Q = L = 256.  After t = 2 pushes a row of f holds ~5k
// nonzeros of 2^20, and the rows' union about a fifth of the columns, so
// the design skips the zeros, which is exact: acc + 0 * x is acc.
//
// A pull, with no float atomics: each output entry is summed by one
// thread in one fixed order -- s first, then the terms f[q, v] * vals[v,
// j] in ascending (v, j) -- each product rounded, then added, as the
// plain version's sequential scatter-add on the CPU does.  The order comes
// from the index's transposed view (`PPRIndex.columns`, built once per
// index): for each output column c, its entries (v, vals[v, j]) with
// vals != 0 in ascending (v, j), in CSR form.
//   1. `f_columns_kernel`, the only read of f: a block owns 32 vertices
//      and one tile of kQT query rows; it claims one run of the q tile's
//      `pairs` for them (an atomic add on a count: it places the pairs,
//      it orders no sum) and writes, per vertex, the tile's nonzeros (q,
//      f[q, v]) in q order, and where they start and how many
//      (`meta`).  Packed, they are a few MB: L2 keeps them for the pull.
//   2. `pull_kernel`: a block owns kCols consecutive output columns (64 B
//      of each out row, whole 32 B sectors) and a q tile, its sums in
//      shared memory, started from s.  A warp takes a column's entries
//      64 at a time (the loads of two groups of 32 in flight together),
//      reads each entry's vertex's meta, and expands a group's pairs 32
//      at a time: lane i adds one term to acc[column][q].  Lanes that
//      hold the same q add in lane order, which is entry order.  The
//      block writes its columns row by row, s folded in, once.
//      A column of more than `seg` entries (a vertex that is in many index
//      rows) is split: the column's block sums its first seg entries, and
//      each further run of seg entries is a task of its own, one warp's,
//      summed from 0 into `carry`;
//   3. `fold_kernel` adds a split column's partial sums to out, in task
//      order.
// Every sum runs in a fixed order whatever the schedule, so two launches
// give the same bits; a column of at most seg entries is bit-equal to the
// plain version on the CPU, a split one on inputs whose sums are exact.
// What the pull costs beyond its bytes is the terms themselves: at
// rmat(20), Q = 256, the nonzeros of f touch ~3e8 index entries, each one
// shared-memory add in its entry's order; the view's scan adds its own
// stream (8 B an entry, ~1 GB).
#include <cuda_runtime.h>

namespace {

constexpr int kQT = 256;       // query rows of a q tile
constexpr int kCols = 16;      // output columns per pull block (64 B)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAt = 32 / kCols;  // out rows a warp reads at once
constexpr int kColsF = 32;     // vertices per f_columns block
constexpr int kGroups = 2;     // 32-entry groups a warp loads together
constexpr int kPairLoads = 2;  // 32-pair batches a warp loads together

__global__ void __launch_bounds__(kThreads)
f_columns_kernel(const float* __restrict__ f, int q, int nv,
                 int2* __restrict__ pairs, int2* __restrict__ meta,
                 int* __restrict__ n_pairs) {
  __shared__ float tile[kQT][kColsF + 1];
  __shared__ int count[kColsF];
  __shared__ int start[kColsF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * kColsF, qt = blockIdx.y, q0 = qt * kQT;
  const int rows = min(kQT, q - q0);
  for (int r = warp; r < rows; r += kWarps) {  // f is read once: stream it
    const int v = v0 + lane;
    tile[r][lane] = v < nv ? __ldcs(f + (long long)(q0 + r) * nv + v) : 0.0f;
  }
  __syncthreads();
  for (int x = warp; x < kColsF; x += kWarps) {
    int n = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      n += __popc(__ballot_sync(0xffffffffu, r < rows && tile[r][x] != 0.0f));
    }
    if (lane == 0) count[x] = v0 + x < nv ? n : 0;
  }
  __syncthreads();
  if (warp == 0) {  // the block's pairs go to one run of the q tile's region
    const int c = count[lane];
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(n_pairs + qt, incl);
    base = __shfl_sync(0xffffffffu, base, 31);
    start[lane] = base + incl - c;
  }
  __syncthreads();
  int2* pairs_t = pairs + (long long)qt * nv * kQT;
  for (int x = warp; x < kColsF; x += kWarps) {
    const int v = v0 + x;
    if (v >= nv) break;
    int2* out = pairs_t + start[x];
    int n = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const float x_ = r < rows ? tile[r][x] : 0.0f;
      const bool nz = x_ != 0.0f;
      const unsigned b = __ballot_sync(0xffffffffu, nz);
      if (nz) out[n + __popc(b & ((1u << lane) - 1u))] =
          make_int2(r, __float_as_int(x_));
      n += __popc(b);
    }
    if (lane == 0) meta[(long long)qt * nv + v] = make_int2(start[x], n);
  }
}

// One warp adds the pair terms of 32 entries (one per lane: value w, and
// where its vertex's k pairs start, k = 0 for an entry that adds nothing)
// into its column's sums a[0, rows) (shared memory), in entry order.
__device__ __forceinline__ void add_entries(float* a, int off, float w, int k,
                                            const int2* __restrict__ pairs_t) {
  const int lane = threadIdx.x & 31;
  int incl = k;  // inclusive scan of the pair counts
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int excl = incl - k;
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  for (int p0 = 0; p0 < total; p0 += 32 * kPairLoads) {
    int qi[kPairLoads];
    float term[kPairLoads];
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      const int p = p0 + 32 * u + lane;
      // the entry that holds pair p: the last lane whose range starts at
      // or before p (lanes without pairs start where the next one does)
      int owner = 0;
      for (int step = 16; step > 0; step >>= 1) {
        const int ex = __shfl_sync(0xffffffffu, excl, owner + step);
        if (ex <= p) owner += step;
      }
      const int po = __shfl_sync(0xffffffffu, off, owner);
      const float pw = __shfl_sync(0xffffffffu, w, owner);
      const int pe = __shfl_sync(0xffffffffu, excl, owner);
      qi[u] = -1;
      term[u] = 0.0f;
      if (p < total) {
        const int2 pr = __ldg(pairs_t + po + (p - pe));
        qi[u] = pr.x;
        term[u] = __fmul_rn(__int_as_float(pr.y), pw);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      // lanes of one q add in lane order (their entries' order)
      const unsigned same = __match_any_sync(0xffffffffu, qi[u]);
      const int rank = __popc(same & ((1u << lane) - 1u));
      const int rounds =
          __reduce_max_sync(0xffffffffu, qi[u] >= 0 ? __popc(same) : 0);
      for (int rr = 0; rr < rounds; ++rr) {
        if (qi[u] >= 0 && rank == rr) a[qi[u]] = __fadd_rn(a[qi[u]], term[u]);
        __syncwarp();
      }
    }
  }
}

// One warp adds the terms of entries [e0, e1) of the view into its
// column's sums a[0, rows), in entry order; kGroups groups of 32 entries
// have their loads in flight together.
// The view's entries are read once (streamed); meta and pairs, a few MB,
// are read again and again and stay in L2.
__device__ void pull_entries(float* a, int e0, int e1,
                             const int* __restrict__ ent_v,
                             const float* __restrict__ ent_w,
                             const int2* __restrict__ meta_t,
                             const int2* __restrict__ pairs_t) {
  const int lane = threadIdx.x & 31;
  for (int b = e0; b < e1; b += 32 * kGroups) {
    int v[kGroups];
    float w[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int e = b + 32 * i + lane;
      v[i] = e < e1 ? __ldcs(ent_v + e) : -1;
      w[i] = e < e1 ? __ldcs(ent_w + e) : 0.0f;
    }
    int2 m[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      m[i] = v[i] >= 0 ? __ldg(meta_t + v[i]) : make_int2(0, 0);
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      add_entries(a, m[i].x, w[i], m[i].y, pairs_t);
  }
}

// Blocks [0, n_tiles): kCols output columns each, their first seg entries,
// out written.  Blocks after: kWarps split tasks each, partials to carry.
// 8 blocks an SM (32 registers a thread): the pull waits on loads and
// shuffles, and more warps in flight hide more of it
__global__ void __launch_bounds__(kThreads, 8)
pull_kernel(const float* __restrict__ s, const int* __restrict__ col_ptr,
            const int* __restrict__ ent_v, const float* __restrict__ ent_w,
            const int* __restrict__ tasks, int n_tasks,
            const int2* __restrict__ meta, const int2* __restrict__ pairs,
            int q, int n, int nv, int seg, int n_tiles,
            float* __restrict__ carry, float* __restrict__ out) {
  __shared__ float acc[kCols][kQT + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = blockIdx.y, q0 = qt * kQT;
  const int rows = min(kQT, q - q0);
  const int2* meta_t = meta + (long long)qt * nv;
  const int2* pairs_t = pairs + (long long)qt * nv * kQT;
  if ((int)blockIdx.x < n_tiles) {
    const int c0 = blockIdx.x * kCols;
    // s, read row by row: half a warp per row, a lane per column
    const int x = lane % kCols;
    for (int r = kRowsAt * warp + lane / kCols; r < rows;
         r += kRowsAt * kWarps) {
      const int c = c0 + x;
      acc[x][r] = c < n ? __ldcs(s + (long long)(q0 + r) * n + c) : 0.0f;
    }
    __syncthreads();
    for (int xc = warp; xc < kCols; xc += kWarps) {
      const int c = c0 + xc;
      if (c >= n) break;
      const int e0 = col_ptr[c];
      const int e1 = min(col_ptr[c + 1], e0 + seg);
      pull_entries(acc[xc], e0, e1, ent_v, ent_w, meta_t, pairs_t);
    }
    __syncthreads();
    for (int r = kRowsAt * warp + lane / kCols; r < rows;
         r += kRowsAt * kWarps) {
      const int c = c0 + x;
      if (c < n) __stcs(out + (long long)(q0 + r) * n + c, acc[x][r]);
    }
    return;
  }
  const int task = (blockIdx.x - n_tiles) * kWarps + warp;
  if (task >= n_tasks) return;
  float* a = acc[warp];
  for (int r = lane; r < rows; r += 32) a[r] = 0.0f;
  __syncwarp();
  pull_entries(a, tasks[3 * task + 1], tasks[3 * task + 2], ent_v, ent_w,
               meta_t, pairs_t);
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    carry[(long long)task * q + q0 + r] = a[r];
}

// heavy [H, 3]: (column, first task, tasks) of each split column.
__global__ void fold_kernel(const int* __restrict__ heavy,
                            const float* __restrict__ carry, int q, int n,
                            float* __restrict__ out) {
  const int h = blockIdx.x;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const int c = heavy[3 * h], first = heavy[3 * h + 1];
  const int count = heavy[3 * h + 2];
  float v = out[(long long)qi * n + c];
  for (int t = 0; t < count; ++t)
    v = __fadd_rn(v, carry[(long long)(first + t) * q + qi]);
  out[(long long)qi * n + c] = v;
}

}  // namespace

extern "C" int index_combine_q_tile() { return kQT; }

// s, out [q, n]; f [q, nv]; the view: col_ptr [n + 1], ent_v / ent_w
// [nnz], tasks [n_tasks, 3], heavy [n_heavy, 3], seg.  Scratch: pairs
// [q tiles, nv * kQT] int2 (each q tile's run filled from its start),
// meta [q tiles, nv] int2 (start, count), n_pairs [q tiles] (zeroed
// here), carry [n_tasks, q].
extern "C" int index_combine_dense_launch(
    const void* s, const void* f, const void* col_ptr, const void* ent_v,
    const void* ent_w, const void* tasks, int n_tasks, const void* heavy,
    int n_heavy, int q, int n, int nv, int seg, void* pairs, void* meta,
    void* n_pairs, void* carry, void* out, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int q_tiles = (q + kQT - 1) / kQT;
  if (nv > 0) {
    cudaError_t err = cudaMemsetAsync(n_pairs, 0, q_tiles * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nv + kColsF - 1) / kColsF, q_tiles);
    f_columns_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)f, q, nv, (int2*)pairs, (int2*)meta, (int*)n_pairs);
  }
  const int n_tiles = (n + kCols - 1) / kCols;
  const dim3 grid(n_tiles + (n_tasks + kWarps - 1) / kWarps, q_tiles);
  pull_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)s, (const int*)col_ptr, (const int*)ent_v,
      (const float*)ent_w, (const int*)tasks, n_tasks, (const int2*)meta,
      (const int2*)pairs, q, n, nv, seg, n_tiles, (float*)carry,
      (float*)out);
  if (n_heavy > 0) {
    const dim3 fgrid(n_heavy, (q + kThreads - 1) / kThreads);
    fold_kernel<<<fgrid, kThreads, 0, st>>>((const int*)heavy,
                                            (const float*)carry, q, n,
                                            (float*)out);
  }
  return (int)cudaGetLastError();
}
