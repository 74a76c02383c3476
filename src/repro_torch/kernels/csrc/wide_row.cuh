// Wide rows spread over many blocks: the exact merge of duplicate columns
// and the ranked selection of a query row whose candidates are too many
// for one block's shared memory (a row that gathers a hub's edges).
//
// One block per row makes a launch as slow as its widest row: 284,280
// candidates sorted by 512 threads of one SM while the others idle.  Here
// every stage is spread over the whole grid, and the rows' candidates sit
// in one global scratch:
//
//   row q owns keys[off[q], off[q] + padded(count[q])), off a multiple of
//   kTileKeys (claimed by `claim_region` with an atomicAdd on a running
//   total, so the regions are disjoint in whatever order the atomics
//   land, and lists the row in wide_rows), tile_row[t] names the row of
//   tile t (`tile_map_kernel`), and the pads past count[q] hold kEmpty;
//
//   1. the caller's gather writes each candidate's value and its key
//      column << 32 | position (position in candidate order) one tile of
//      kTileKeys keys per block, and sorts the tile in shared memory
//      (`sort_tile`: 128 KB of dynamic shared memory, only the tile's
//      next_pow2(filled) prefix is sorted);
//   2. `merge_pass_kernel`, one launch per doubling of the sorted run
//      length: every block writes kChunk keys of one merged pair of runs,
//      its split of the two inputs found by a merge-path search, so each
//      pass is spread evenly over the grid however skewed the rows are;
//   3. `group_sum_kernel`: one thread per key; a group's first key sums
//      the group's values in key order (candidate order, the plain
//      version's sequential segment sum) and writes the rank key
//      ~bits(sum) << 32 | local column of a positive sum (owner-local for
//      n_shard-wide owners), every other key kEmpty; ascending rank keys
//      rank by value descending, then column ascending;
//   4. `select_run` (one block per run of rank keys, e.g. a row's run of
//      one owner's columns, which is contiguous in column order): the k
//      smallest rank keys in ascending order, by rounds of an 8-bit radix
//      select of at most kSelect keys each and a shared-memory sort of
//      what the round selected, so no run is ever sorted whole.
//
// Every step is deterministic: a sum runs in candidate order and a key is
// unique within its row (the position, or the column of its group).
#pragma once

#include "compact.cuh"

namespace wr {

constexpr int kThreads = 1024;
constexpr int kTileKeys = 16384;  // keys of one block's tile sort (128 KB)
constexpr int kChunk = 4096;      // merged keys one merge-path block writes
constexpr int kSelect = kTileKeys;  // most keys one select round sorts
constexpr int kUnroll = 8;        // keys a thread loads at once in a pass
constexpr int kSlotWords = 8192;  // slot offsets a gather block keeps
constexpr int kTileBytes = kTileKeys * 8;
constexpr int kMergeBytes = 2 * kChunk * 8;
constexpr int kSelectBytes = kSelect * 8;
using u64 = unsigned long long;

__device__ __forceinline__ long long padded(int w) {
  return ((long long)w + kTileKeys - 1) / kTileKeys * kTileKeys;
}

// Claim a region for a wide row of w keys: totals[0] is the running total
// of the regions, totals[1] the longest region.  One thread per row.
__device__ __forceinline__ long long claim_region(int w,
                                                  unsigned long long* totals) {
  unsigned long long width = (unsigned long long)padded(w);
  atomicMax(&totals[1], width);
  return (long long)atomicAdd(&totals[0], width);
}

// Block-wide exclusive scan of one int per thread (blockDim.x <= 1024, a
// multiple of 32); the block total in *total.  scratch needs 32 ints.
__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int off = 0, all = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    int c = scratch[w];
    off += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return off + incl - v;
}

// tile_row[t] = q for every tile of each wide row q (one block per row of
// the list wide_rows).
__global__ void tile_map_kernel(const int* __restrict__ wide_rows,
                                const int* __restrict__ count,
                                const long long* __restrict__ off,
                                int* __restrict__ tile_row) {
  const int q = wide_rows[blockIdx.x];
  const int w = count[q];
  const long long t0 = off[q] / kTileKeys;
  const int nt = (int)(padded(w) / kTileKeys);
  for (int i = threadIdx.x; i < nt; i += blockDim.x) tile_row[t0 + i] = q;
}

// Sort a shared-memory tile whose first n keys are real and the rest
// kEmpty.  Every thread of the block must call it.
__device__ __forceinline__ void sort_tile(u64* tile, int n) {
  __syncthreads();
  pw::bitonic_sort(tile, pw::next_pow2(n > 0 ? n : 1));
}

// How many A elements the first diag keys of merge(A, B) take, ties to A.
__device__ __forceinline__ int merge_path(const u64* a, int na, const u64* b,
                                          int nb, int diag) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// How many of the n ascending keys at a are <= key.
__device__ __forceinline__ int count_upto(const u64* a, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One merge pass: every row's sorted runs of length run (a multiple of
// kTileKeys) merged pairwise into runs of 2 * run, in -> out.  Grid: one
// block per kChunk keys of the scratch; dynamic shared memory kMergeBytes.
__global__ void __launch_bounds__(kThreads)
merge_pass_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                  const int* __restrict__ tile_row,
                  const long long* __restrict__ off,
                  const int* __restrict__ count, long long run) {
  extern __shared__ u64 buf[];
  __shared__ int split[2];
  const long long o0 = (long long)blockIdx.x * kChunk;
  const int q = tile_row[o0 / kTileKeys];
  const long long base = off[q];
  const long long len = padded(count[q]);
  const long long p = o0 - base;
  const long long pair = p / (2 * run) * (2 * run);
  const int na = (int)min(run, len - pair);
  const int nb = (int)max(0LL, min(run, len - pair - run));
  const u64* a = in + base + pair;
  const u64* b = a + na;
  const int d0 = (int)(p - pair);
  if (threadIdx.x < 2)
    split[threadIdx.x] = merge_path(a, na, b, nb, d0 + threadIdx.x * kChunk);
  __syncthreads();
  const int i0 = split[0], j0 = d0 - i0;
  const int ma = split[1] - i0, mb = kChunk - ma;
  u64* sa = buf;
  u64* sb = buf + ma;
  u64* so = buf + kChunk;
  for (int t = threadIdx.x; t < ma; t += blockDim.x) sa[t] = a[i0 + t];
  for (int t = threadIdx.x; t < mb; t += blockDim.x) sb[t] = b[j0 + t];
  __syncthreads();
  for (int t = threadIdx.x; t < kChunk; t += blockDim.x) {
    if (t < ma) {
      const u64 x = sa[t];
      so[t + pw::count_below(sb, mb, x)] = x;       // B's equal keys after
    } else {
      const u64 x = sb[t - ma];
      so[t - ma + count_upto(sa, ma, x)] = x;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kChunk; t += blockDim.x) out[o0 + t] = so[t];
}

// Group sums over the sorted keys (column << 32 | position) of every row:
// out[t] = ~bits(sum) << 32 | (column mod n_shard) at each group's first
// key if its sum is positive, else kEmpty.  One thread per key.
__global__ void group_sum_kernel(const u64* __restrict__ keys,
                                 const float* __restrict__ cv,
                                 u64* __restrict__ out,
                                 const int* __restrict__ tile_row,
                                 const long long* __restrict__ off,
                                 const int* __restrict__ count,
                                 long long total, unsigned n_shard) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int q = tile_row[t / kTileKeys];
  const long long base = off[q];
  const long long end = base + count[q];
  u64 res = pw::kEmpty;
  if (t < end) {
    const u64 kt = keys[t];
    const unsigned col = (unsigned)(kt >> 32);
    if (t == base || (unsigned)(keys[t - 1] >> 32) != col) {
      float s = cv[base + (unsigned)kt];
      for (long long u = t + 1; u < end; ++u) {
        const u64 ku = keys[u];
        if ((unsigned)(ku >> 32) != col) break;
        s = __fadd_rn(s, cv[base + (unsigned)ku]);
      }
      if (s > 0.0f) {
        const unsigned local = col - (col / n_shard) * n_shard;
        res = ((u64)(~__float_as_uint(s)) << 32) | local;
      }
    }
  }
  out[t] = res;
}

// Shared-memory words select_run needs for a top-k: next_pow2(k), at
// most kSelect.
__host__ __device__ inline int select_words(int k) {
  int p = 1;
  while (p < k && p < kSelect) p <<= 1;
  return p;
}

// The k smallest of the distinct rank keys at keys[0, n) (kEmpty entries
// ignored), ascending, as write(i, key) for i < k; write(i, kEmpty) for
// the slots past the last key.  Rounds of at most select_words(k) keys:
// an 8-bit MSD radix select of the round's last key among the keys above
// the last round's (ending at the first pass whose bucket is taken
// whole), then a bitonic sort of the round's keys in tile
// (select_words(k) words of shared memory).  Every thread of the block
// must call it.
template <class Write>
__device__ void select_run(const u64* __restrict__ keys, int n, int k,
                           u64* tile, Write write) {
  __shared__ int hist[256];
  __shared__ int red[32];
  __shared__ int pick[4];
  const int cap = select_words(k);
  const int lane = threadIdx.x & 31;
  const int step = kUnroll * blockDim.x;
  u64 last = 0;
  bool has_last = false;
  int written = 0;
  // every pass over the run loads kUnroll keys a thread before it uses any
  auto load = [&](int t0, u64* x) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * blockDim.x + threadIdx.x;
      x[u] = t < n ? keys[t] : pw::kEmpty;
    }
  };
  auto above = [&](u64 x) {
    return x != pw::kEmpty && (!has_last || x > last);
  };
  while (written < k) {
    const int want = min(k - written, cap);
    // radix passes, 8 bits at a time from the top: the first one also
    // counts the keys left; a pass whose bucket is taken whole ends it
    u64 prefix = 0, mask = 0, thr = pw::kEmpty;
    int rank = want;  // rank of the round's last key inside the bucket
    int avail = 0;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      for (int t0 = 0; t0 < n; t0 += step) {
        u64 x[kUnroll];
        load(t0, x);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool hit = above(x[u]) && (x[u] & mask) == prefix;
          const int bin = hit ? (int)((x[u] >> shift) & 255) : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, bin);
          if (hit && lane == __ffs(peers) - 1)
            atomicAdd(&hist[bin], __popc(peers));
        }
      }
      __syncthreads();
      if (threadIdx.x < 32) {  // warp 0 finds the bucket of the rank-th key
        int c = 0;
        for (int i = 0; i < 8; ++i) c += hist[8 * lane + i];
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += up;
        }
        const unsigned reach = __ballot_sync(0xffffffffu, incl >= rank);
        if (lane == 31) pick[3] = incl;
        if (reach && lane == __ffs(reach) - 1) {
          int b = 8 * lane, below = incl - c;
          while (below + hist[b] < rank) below += hist[b++];
          pick[0] = b;
          pick[1] = below;
          pick[2] = hist[b];
        }
      }
      __syncthreads();
      if (shift == 56) {
        avail = pick[3];
        if (avail <= want) break;  // take every key left (thr = kEmpty)
      }
      rank -= pick[1];
      prefix |= (u64)pick[0] << shift;
      mask |= 0xFFULL << shift;
      const bool whole = pick[2] == rank;
      __syncthreads();
      if (whole) {  // keys are distinct: exactly want of them are <= thr
        thr = prefix | ((1ULL << shift) - 1ULL);
        break;
      }
    }
    if (avail == 0) break;
    int m = 0;
    for (int t0 = 0; t0 < n; t0 += step) {
      u64 x[kUnroll];
      load(t0, x);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // in key order
        const bool keep = above(x[u]) && x[u] <= thr;
        int total;
        const int at = pw::block_rank(keep, red, &total);
        if (keep) tile[m + at] = x[u];
        m += total;
      }
    }
    const int p = pw::next_pow2(m);
    for (int t = m + threadIdx.x; t < p; t += blockDim.x) tile[t] = pw::kEmpty;
    __syncthreads();
    pw::bitonic_sort(tile, p);
    for (int t = threadIdx.x; t < m; t += blockDim.x) write(written + t, tile[t]);
    written += m;
    last = thr;
    has_last = true;
    __syncthreads();
  }
  for (int t = written + threadIdx.x; t < k; t += blockDim.x)
    write(t, pw::kEmpty);
}

}  // namespace wr
