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
// Per query row (one block):
//   1. gather the real out-edges of the row's live slots (fv > 0, the first
//      min(deg, degree_cap) edges of the slab row, deg from the slab's
//      row_ptr), each weighted (1-c)*fv/deg rounded as the plain version;
//   2. merge duplicate columns exactly (merge_groups of compact.cuh: a sort
//      by (column, position), each group summed in candidate order);
//   3. rank the positive groups by one 64-bit key (owner, value descending,
//      local column ascending) and write the first wire_k of each owner's
//      run; empty slots are (0.0, 0).  Owners are contiguous column ranges,
//      so the key needs the owner's bits, 31 bits of the positive value's
//      complemented bits and the local column's bits; the wrapper checks
//      that they fit in 64.
// The TPU kernel gathers fixed windows of K*s*h lanes per row (7.2M at the
// main path's K = 256, s = 437, h = 64); here masked lanes are never
// gathered, and hub_split_degree, TPU geometry only, plays no part.
//
// Bound: bytes -- 4 B of col_idx per real edge gathered, the row_ptr pair
// and (fv, fi) per slot, 8 B per output entry.  What it costs instead is
// the per-row sorts: a row of up to kSmemP edges merges in shared memory,
// a wider row in its slice of a global scratch sized by the row's real
// edge count (next_pow2 of it), sorted by compact.cuh's tiled bitonic
// network.  One block per row, so the row with the most edges sets the
// launch's time.
//
// A first, small kernel (sharded_push_size_kernel) counts each row's real
// edges once and claims the row's scratch slice with an atomicAdd on a
// running total; the wrapper reads that total back to allocate the scratch
// and the push kernel reads the counts and offsets.  Slices are disjoint in
// whatever order the atomics land, so the answer does not depend on it.
#include "compact.cuh"

constexpr int kThreads = 512;

extern "C" __global__ void __launch_bounds__(kThreads)
sharded_push_size_kernel(const float* __restrict__ fv,
                         const int* __restrict__ fi, int k,
                         const int* __restrict__ row_ptr, int degree_cap,
                         int* count, long long* g_off,
                         unsigned long long* g_total) {
  __shared__ int red[32];
  const long long q = blockIdx.x;
  int part = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (fv[q * k + j] > 0.0f) {
      int v = fi[q * k + j];
      part += min(row_ptr[v + 1] - row_ptr[v], degree_cap);
    }
  }
  const int w = pw::block_sum(part, red);
  if (threadIdx.x == 0) {
    count[q] = w;
    // rows that fit in shared memory take no global scratch
    unsigned long long width = w > pw::kSmemP ? pw::next_pow2(w) : 0;
    g_off[q] = width ? (long long)atomicAdd(g_total, width) : 0;
  }
}

extern "C" __global__ void __launch_bounds__(kThreads)
sharded_push_kernel(const float* __restrict__ fv, const int* __restrict__ fi,
                    int k, const int* __restrict__ row_ptr,
                    const int* __restrict__ col_idx, float omc,
                    int degree_cap, int ep, int n_shard, int local_bits,
                    int wire_k, const int* __restrict__ count,
                    const long long* __restrict__ g_off, float* g_cv,
                    int* g_ci, unsigned long long* g_keys, float* out_v,
                    int* out_i) {
  __shared__ pw::Smem sm;

  const long long q = blockIdx.x;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;
  const int w = count[q];  // the row's real edges
  const bool smem = w <= pw::kSmemP;
  float* cv = smem ? sm.cv() : g_cv + g_off[q];
  int* ci = smem ? sm.ci() : g_ci + g_off[q];
  unsigned long long* keys = smem ? sm.keys() : g_keys + g_off[q];
  unsigned long long* tile = smem ? nullptr : sm.words;

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
  const int d = pw::merge_groups(cv, ci, keys, w, tile, sm.red);

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
  pw::sort_keys(keys, p2, tile);

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

// g_total must hold 0 on entry; on return it holds the scratch words the
// push needs.
extern "C" int sharded_frontier_push_size_launch(
    const void* fv, const void* fi, int q, int k, const void* row_ptr,
    int degree_cap, void* count, void* g_off, void* g_total, void* stream) {
  if (q <= 0) return 0;
  sharded_push_size_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)fi, k, (const int*)row_ptr, degree_cap,
      (int*)count, (long long*)g_off, (unsigned long long*)g_total);
  return (int)cudaGetLastError();
}

extern "C" int sharded_frontier_push_launch(
    const void* fv, const void* fi, int q, int k, const void* row_ptr,
    const void* col_idx, float omc, int degree_cap, int ep, int n_shard,
    int local_bits, int wire_k, const void* count, const void* g_off,
    void* g_cv, void* g_ci, void* g_keys, void* out_v, void* out_i,
    void* stream) {
  if (q <= 0) return 0;
  sharded_push_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)fi, k, (const int*)row_ptr,
      (const int*)col_idx, omc, degree_cap, ep, n_shard, local_bits, wire_k,
      (const int*)count, (const long long*)g_off, (float*)g_cv, (int*)g_ci,
      (unsigned long long*)g_keys, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
