// sharded_frontier_push: one shard's half-iteration of the distributed
// sparse exchange -- the gather-push of its local frontier slice through its
// CSR slab, one exact merge of duplicate columns, and per-owner top-wire_k
// buckets with owner-local indices, ready for the all_to_all.
//
// Replaces the Pallas TPU kernel `sharded_frontier_push`
// (src/repro/kernels/frontier_push.py:265, body `_sharded_push_kernel`
// :243), which the distributed engine calls once per shard and VERD
// iteration (src/repro/core/distributed_engine.py:446).
//
// Each query row takes one of two paths, by its real edge count w (the
// first min(deg, degree_cap) edges of each live slot: fv > 0, deg from the
// slab's row_ptr), each candidate weighted (1-c)*fv/deg rounded as the
// plain version:
//
// Narrow rows (w <= pw::kSmemP), one block each, all in shared memory:
//   1. gather the row's candidates, slot by slot;
//   2. merge duplicate columns exactly (merge_groups of compact.cuh: a sort
//      by (column, position), each group summed in candidate order);
//   3. rank the positive groups by one 64-bit key (owner, value descending,
//      local column ascending) and write the first wire_k of each owner's
//      run; empty slots are (0.0, 0).  The key needs the owner's bits, 31
//      bits of the positive value's complemented bits and the local
//      column's bits; the wrapper checks that they fit in 64.
//
// Wide rows (a hub's edges; 284,280 candidates in the widest row of the
// main path) are spread over the whole grid by wide_row.cuh:
//   1. `sharded_wide_gather_kernel`: one block per tile of 16,384
//      candidates, each finding its slot by a binary search in the row's
//      per-slot edge offsets, then sorting the tile's (column, position)
//      keys in shared memory;
//   2. merge-path passes merge each row's tiles; group sums write one rank
//      key (value descending, owner-local column ascending) per positive
//      group, in column order;
//   3. `sharded_wide_select_kernel`: one block per (row, owner).  Owners
//      are contiguous column ranges, so an owner's groups are one run of
//      the column-ordered keys (found by binary search); a radix select
//      takes the run's top wire_k, and only those are sorted.
// Both paths sum each group in candidate order and rank by (value desc,
// owner-local column asc), so a row's answer does not depend on its path.
//
// The TPU kernel gathers fixed windows of K*s*h lanes per row (7.2M at the
// main path's K = 256, s = 437, h = 64); here masked lanes are never
// gathered, and hub_split_degree, TPU geometry only, plays no part.
//
// Bound: bytes -- 4 B of col_idx per real edge gathered, the row_ptr pair
// and (fv, fi) per slot, 8 B per output entry.  What it costs instead is
// the sorts of the exact merge, each kept to shared memory or to passes
// spread over every SM.
//
// A first, small kernel (sharded_push_size_kernel) counts each row's real
// edges, writes its per-slot edge offsets, and claims a wide row's scratch
// region with an atomicAdd on a running total (an atomicMax on the longest
// region, and an atomicAdd that lists the row); the wrapper reads those
// three numbers back in one copy to size the scratch and the grids of the
// wide path.  Regions are disjoint and rows independent in whatever order
// the atomics land, so the answer does not depend on it.
#include "wide_row.cuh"

constexpr int kThreads = 512;

extern "C" __global__ void __launch_bounds__(kThreads)
sharded_push_size_kernel(const float* __restrict__ fv,
                         const int* __restrict__ fi, int k,
                         const int* __restrict__ row_ptr, int degree_cap,
                         int* count, long long* g_off, int* slot_off,
                         unsigned long long* totals, int* wide_rows) {
  __shared__ int red[32];
  const long long q = blockIdx.x;
  int* so = slot_off + q * (k + 1);
  int base = 0;
  for (int j0 = 0; j0 < k; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    int budget = 0;
    if (j < k && fv[q * k + j] > 0.0f) {
      int v = fi[q * k + j];
      budget = min(row_ptr[v + 1] - row_ptr[v], degree_cap);
    }
    int total;
    const int at = wr::block_exclusive_scan(budget, red, &total);
    if (j < k) so[j] = base + at;
    base += total;
  }
  if (threadIdx.x == 0) {
    so[k] = base;
    count[q] = base;
    g_off[q] = 0;
    if (base > pw::kSmemP) {
      g_off[q] = wr::claim_region(base, totals);
      wide_rows[atomicAdd(&totals[2], 1ULL)] = (int)q;
    }
  }
}

// The narrow rows; a wide row's block returns at once.
extern "C" __global__ void __launch_bounds__(kThreads)
sharded_push_kernel(const float* __restrict__ fv, const int* __restrict__ fi,
                    int k, const int* __restrict__ row_ptr,
                    const int* __restrict__ col_idx, float omc,
                    int degree_cap, int ep, int n_shard, int local_bits,
                    int wire_k, const int* __restrict__ count, float* out_v,
                    int* out_i) {
  __shared__ pw::Smem sm;

  const long long q = blockIdx.x;
  const int w = count[q];  // the row's real edges
  if (w > pw::kSmemP) return;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;
  float* cv = sm.cv();
  int* ci = sm.ci();
  unsigned long long* keys = sm.keys();

  // 1. gather, slot by slot; neighbouring threads read neighbouring edges
  int base = 0;
  for (int j = 0; j < k; ++j) {
    float f = fvq[j];
    if (!(f > 0.0f)) continue;
    int v = fiq[j];
    int start = row_ptr[v];
    int deg = row_ptr[v + 1] - start;
    int budget = min(deg, degree_cap);
    if (budget <= 0) continue;
    float wt = __fmul_rn(__fmul_rn(omc, f),
                         __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f)));
    for (int e = threadIdx.x; e < budget; e += blockDim.x) {
      cv[base + e] = wt;
      ci[base + e] = col_idx[start + e];
    }
    base += budget;
  }
  __syncthreads();

  // 2. exact merge: keys[0, d) = rank_key(sum, column), column order
  const int d = pw::merge_groups(cv, ci, keys, w, nullptr, sm.red);

  // 3. re-key by (owner, value desc, local column asc) and sort
  const int shift = 31 + local_bits;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    unsigned long long key = keys[t];
    unsigned col = (unsigned)key;
    unsigned owner = col / (unsigned)n_shard;
    unsigned long long value = (key >> 32) & 0x7FFFFFFFULL;
    keys[t] = ((unsigned long long)owner << shift) | (value << local_bits) |
              (unsigned long long)(col - owner * (unsigned)n_shard);
  }
  const int p2 = pw::next_pow2(d > 0 ? d : 1);
  for (int t = d + threadIdx.x; t < p2; t += blockDim.x) keys[t] = pw::kEmpty;
  __syncthreads();
  pw::sort_keys(keys, p2, nullptr);

  const unsigned long long local_mask = (1ULL << local_bits) - 1ULL;
  float* ovq = out_v + q * ep * wire_k;
  int* oiq = out_i + q * ep * wire_k;
  for (int o = 0; o < ep; ++o) {
    int lo = pw::count_below(keys, d, (unsigned long long)o << shift);
    int hi = pw::count_below(keys, d, (unsigned long long)(o + 1) << shift);
    for (int t = threadIdx.x; t < wire_k; t += blockDim.x) {
      float v = 0.0f;
      int c = 0;
      if (lo + t < hi) {
        unsigned long long key = keys[lo + t];
        unsigned high = (unsigned)((key >> local_bits) & 0x7FFFFFFFULL);
        v = __uint_as_float(~(high | 0x80000000u));
        c = (int)(key & local_mask);
      }
      ovq[o * wire_k + t] = v;
      oiq[o * wire_k + t] = c;
    }
  }
}

// One tile of a wide row: gather its candidates (values to g_cv, keys
// column << 32 | position to shared memory), sort the tile, store it.
// Each candidate finds its slot by a binary search in the row's slot
// offsets, kept in shared memory after the tile.
extern "C" __global__ void __launch_bounds__(wr::kThreads)
sharded_wide_gather_kernel(const float* __restrict__ fv,
                           const int* __restrict__ fi, int k,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ col_idx, float omc,
                           const int* __restrict__ count,
                           const long long* __restrict__ g_off,
                           const int* __restrict__ slot_off,
                           const int* __restrict__ tile_row,
                           float* __restrict__ g_cv,
                           unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long tile[];  // then the slot offsets
  const long long t0 = (long long)blockIdx.x * wr::kTileKeys;
  const int q = tile_row[blockIdx.x];
  const long long base = g_off[q];
  const int p0 = (int)(t0 - base);
  const int n = min(wr::kTileKeys, count[q] - p0);
  const int* g_so = slot_off + (long long)q * (k + 1);
  const float* fvq = fv + (long long)q * k;
  const int* fiq = fi + (long long)q * k;
  // the row's slot offsets, in shared memory where they fit
  int* s_so = reinterpret_cast<int*>(tile + wr::kTileKeys);
  const bool staged = k + 1 <= wr::kSlotWords;
  if (staged)
    for (int j = threadIdx.x; j <= k; j += blockDim.x) s_so[j] = g_so[j];
  __syncthreads();
  const int* so = staged ? s_so : g_so;
#pragma unroll 4
  for (int i = threadIdx.x; i < wr::kTileKeys; i += blockDim.x) {
    unsigned long long key = pw::kEmpty;
    if (i < n) {
      const int p = p0 + i;
      int lo = 0, hi = k;  // the last slot j with so[j] <= p
      while (hi - lo > 1) {
        int mid = (lo + hi) >> 1;
        if (so[mid] <= p) lo = mid; else hi = mid;
      }
      const int v = fiq[lo];
      const int start = row_ptr[v];
      const int deg = row_ptr[v + 1] - start;
      g_cv[base + p] = __fmul_rn(__fmul_rn(omc, fvq[lo]),
                                 __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f)));
      key = ((unsigned long long)(unsigned)col_idx[start + p - so[lo]] << 32) |
            (unsigned)p;
    }
    tile[i] = key;
  }
  wr::sort_tile(tile, n);
  for (int i = threadIdx.x; i < wr::kTileKeys; i += blockDim.x)
    keys[t0 + i] = tile[i];
}

// One (wide row, owner) per block: the top wire_k of the owner's run of
// rank keys.
extern "C" __global__ void __launch_bounds__(wr::kThreads)
sharded_wide_select_kernel(const int* __restrict__ wide_rows,
                           const int* __restrict__ count,
                           const long long* __restrict__ g_off,
                           const unsigned long long* __restrict__ sorted,
                           const unsigned long long* __restrict__ ranked,
                           int ep, int n_shard, int wire_k, float* out_v,
                           int* out_i) {
  extern __shared__ unsigned long long tile[];
  const int q = wide_rows[blockIdx.x], o = blockIdx.y;
  const int w = count[q];
  const long long base = g_off[q];
  const unsigned long long lo_col = (unsigned long long)o * n_shard;
  const int lo = pw::count_below(sorted + base, w, lo_col << 32);
  const int hi = pw::count_below(sorted + base, w, (lo_col + n_shard) << 32);
  float* ov = out_v + ((long long)q * ep + o) * wire_k;
  int* oi = out_i + ((long long)q * ep + o) * wire_k;
  wr::select_run(ranked + base + lo, hi - lo, wire_k, tile,
                 [&](int i, unsigned long long key) {
                   ov[i] = pw::key_value(key);
                   oi[i] = pw::key_column(key);
                 });
}

extern "C" int sharded_frontier_push_tile_keys() { return wr::kTileKeys; }

// On return totals (3 words, zeroed here) holds the scratch keys of the
// wide rows, the longest row's region and the count of wide rows, whose
// indices are in wide_rows [q].
extern "C" int sharded_frontier_push_size_launch(
    const void* fv, const void* fi, int q, int k, const void* row_ptr,
    int degree_cap, void* count, void* g_off, void* slot_off, void* totals,
    void* wide_rows, void* stream) {
  if (q <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(totals, 0, 3 * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  sharded_push_size_kernel<<<q, kThreads, 0, s>>>(
      (const float*)fv, (const int*)fi, k, (const int*)row_ptr, degree_cap,
      (int*)count, (long long*)g_off, (int*)slot_off,
      (unsigned long long*)totals, (int*)wide_rows);
  return (int)cudaGetLastError();
}

// The narrow rows' push (needs only the size kernel's counts).
extern "C" int sharded_frontier_push_launch(
    const void* fv, const void* fi, int q, int k, const void* row_ptr,
    const void* col_idx, float omc, int degree_cap, int ep, int n_shard,
    int local_bits, int wire_k, const void* count, void* out_v, void* out_i,
    void* stream) {
  if (q <= 0) return 0;
  sharded_push_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)fi, k, (const int*)row_ptr,
      (const int*)col_idx, omc, degree_cap, ep, n_shard, local_bits, wire_k,
      (const int*)count, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}

constexpr int kGatherBytes = wr::kTileBytes + 4 * wr::kSlotWords;

// The wide path's dynamic shared memory, by tile parameter: a gather
// block's tile and the row's slot offsets where they fit, a select round's
// keys (a merge pass takes wr::kMergeBytes).
inline int wide_gather_smem(int k) {
  return wr::kTileBytes + 4 * (k + 1 <= wr::kSlotWords ? k + 1 : 0);
}
inline int wide_select_smem(int wire_k) {
  return wr::select_words(wire_k) * 8;
}

// The bytes the wide launches take at (k, wire_k): gather, merge pass and
// select, in that order (the contract audit reads them: one source for
// the sizes).
extern "C" void sharded_frontier_push_wide_smem(int k, int wire_k,
                                                int* bytes) {
  bytes[0] = wide_gather_smem(k);
  bytes[1] = wr::kMergeBytes;
  bytes[2] = wide_select_smem(wire_k);
}

static int allow_wide_smem() {
  static int err = -1;  // once per process
  if (err < 0) {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = (int)cudaFuncSetAttribute(sharded_wide_gather_kernel, a,
                                    kGatherBytes);
    if (!err) err = (int)cudaFuncSetAttribute(wr::merge_pass_kernel, a,
                                              wr::kMergeBytes);
    if (!err) err = (int)cudaFuncSetAttribute(sharded_wide_select_kernel, a,
                                              wr::kSelectBytes);
  }
  return err;
}

// The wide rows' push: total, longest and n_wide are the size kernel's
// totals (total > 0).  Scratch: tile_row [total / kTileKeys], g_cv
// [total], keys_a and keys_b [total].
extern "C" int sharded_frontier_push_wide_launch(
    const void* fv, const void* fi, int k, const void* row_ptr,
    const void* col_idx, float omc, int ep, int n_shard, int wire_k,
    const void* count, const void* g_off, const void* slot_off,
    const void* wide_rows, long long total, long long longest, int n_wide,
    void* tile_row, void* g_cv, void* keys_a, void* keys_b, void* out_v,
    void* out_i, void* stream) {
  if (n_wide <= 0 || total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = allow_wide_smem();
  if (err) return err;
  const int* cnt = (const int*)count;
  const long long* off = (const long long*)g_off;
  const int* wide = (const int*)wide_rows;
  int* rows = (int*)tile_row;
  wr::tile_map_kernel<<<n_wide, 256, 0, s>>>(wide, cnt, off, rows);
  unsigned long long* cur = (unsigned long long*)keys_a;
  unsigned long long* nxt = (unsigned long long*)keys_b;
  sharded_wide_gather_kernel<<<(unsigned)(total / wr::kTileKeys),
                               wr::kThreads, wide_gather_smem(k), s>>>(
      (const float*)fv, (const int*)fi, k, (const int*)row_ptr,
      (const int*)col_idx, omc, cnt, off, (const int*)slot_off, rows,
      (float*)g_cv, cur);
  for (long long run = wr::kTileKeys; run < longest; run *= 2) {
    wr::merge_pass_kernel<<<(unsigned)(total / wr::kChunk), wr::kThreads,
                            wr::kMergeBytes, s>>>(cur, nxt, rows, off, cnt,
                                                  run);
    unsigned long long* t = cur;
    cur = nxt;
    nxt = t;
  }
  wr::group_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      cur, (const float*)g_cv, nxt, rows, off, cnt, total,
      (unsigned)n_shard);
  sharded_wide_select_kernel<<<dim3(n_wide, ep), wr::kThreads,
                               wide_select_smem(wire_k), s>>>(
      wide, cnt, off, cur, nxt, ep, n_shard, wire_k, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
