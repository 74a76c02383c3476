// Block-level compact_arrays: dedup-merge by column, then rank by
// (value descending, column ascending) -- the re-compaction law of
// repro_torch.core.frontier.compact_arrays, shared by frontier_push.cu,
// index_combine.cu and (the merge half) sharded_frontier_push.cu.
//
// One thread block owns one query row.  Candidates sit in (cv, ci) in
// candidate order and are ranked by two sorts of 64-bit keys:
//   1. key = column << 32 | candidate position: groups duplicates, and the
//      position tiebreak keeps each group in candidate order, so a group is
//      summed in the same order as the sequential segment sum of the plain
//      version;
//   2. over the positive group sums only (compacted first),
//      key = ~bits(sum) << 32 | column: positive float bits are monotone,
//      so ascending keys rank by value descending, then column ascending.
// The buffers live in shared memory when the row's candidate width fits
// kSmemP; wider rows use the row's slice of a wrapper-allocated global
// scratch, sorted by a tiled bitonic network: every compare distance below
// kTile runs inside a shared-memory tile, so only the few long-distance
// steps make a pass over global memory.  When more than kTile groups
// survive and the caller needs at most kSmemP of them, the second sort is
// replaced by a radix select of the top entries (select_smallest).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Phase timers: a source that defines PW_TICK before including this header
// (index_combine.cu, built with -DPW_PHASE_TIMERS) marks the end of each
// phase of merge_groups and compact_block; elsewhere the marks are empty.
#ifndef PW_TICK
#define PW_TICK(phase)
#endif

namespace pw {

constexpr int kSmemP = 2048;   // candidates a block sorts in shared memory
constexpr int kTile = 4096;    // keys of one shared-memory tile (32 KB)
constexpr unsigned long long kEmpty = ~0ULL;

// The block's shared memory: keys | cv | ci of a shared-memory fold
// (2048 + 1024 + 1024 words), or one tile of a global sort.
struct Smem {
  unsigned long long words[kTile];
  int red[32];
  int hist[256];
  __device__ unsigned long long* keys() { return words; }
  __device__ float* cv() { return reinterpret_cast<float*>(words + kSmemP); }
  __device__ int* ci() {
    return reinterpret_cast<int*>(words + kSmemP + kSmemP / 2);
  }
};

__device__ __forceinline__ int next_pow2(int w) {
  int p = 1;
  while (p < w) p <<= 1;
  return p;
}

// One compare-exchange step (k, j) of the ascending bitonic network over
// the n keys at keys[0, n), whose first key has network index base.
__device__ __forceinline__ void bitonic_step(unsigned long long* keys, int n,
                                             int base, int k, int j) {
  for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
    int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // pair (i, i + j)
    unsigned long long a = keys[i];
    unsigned long long b = keys[i + j];
    bool up = ((base + i) & k) == 0;
    if ((a > b) == up) {
      keys[i] = b;
      keys[i + j] = a;
    }
  }
}

// Ascending bitonic sort of p (a power of two) keys that all fit where
// they are (shared memory, or a small global slice).  Every thread of the
// block must call it.
__device__ void bitonic_sort(unsigned long long* keys, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_step(keys, p, 0, k, j);
      __syncthreads();
    }
  }
}

// The steps (k, j) for j = from .. 1 on every kTile-key tile of the global
// keys[0, p), each tile loaded once into shared memory.
__device__ void tile_steps(unsigned long long* keys, int p,
                           unsigned long long* tile, int k_lo, int k_hi) {
  for (int t0 = 0; t0 < p; t0 += kTile) {
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) tile[i] = keys[t0 + i];
    __syncthreads();
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      for (int j = min(k, kTile) >> 1; j > 0; j >>= 1) {
        bitonic_step(tile, kTile, t0, k, j);
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) keys[t0 + i] = tile[i];
    __syncthreads();
  }
}

// Ascending sort of p keys (a power of two).  tile == nullptr: keys are in
// shared memory.  Otherwise keys are global and tile is kTile words of
// shared memory: the same bitonic network, with every step of compare
// distance j < kTile run tile-locally (its pairs never leave a tile).
__device__ void sort_keys(unsigned long long* keys, int p,
                          unsigned long long* tile) {
  if (tile == nullptr) {
    bitonic_sort(keys, p);
    return;
  }
  if (p <= kTile) {
    for (int i = threadIdx.x; i < p; i += blockDim.x) tile[i] = keys[i];
    __syncthreads();
    bitonic_sort(tile, p);
    for (int i = threadIdx.x; i < p; i += blockDim.x) keys[i] = tile[i];
    __syncthreads();
    return;
  }
  tile_steps(keys, p, tile, 2, kTile);
  for (int k = 2 * kTile; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= kTile; j >>= 1) {
      bitonic_step(keys, p, 0, k, j);
      __syncthreads();
    }
    tile_steps(keys, p, tile, k, k);
  }
}

// Rank key of a positive value: ascending keys rank by value descending
// (positive float bits are monotone), then column ascending.
__device__ __forceinline__ unsigned long long rank_key(float v, unsigned col) {
  return ((unsigned long long)(~__float_as_uint(v)) << 32) | col;
}

// How many of the n ascending keys at a are below key.
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return key == kEmpty ? 0.0f : __uint_as_float(~(unsigned)(key >> 32));
}

__device__ __forceinline__ int key_column(unsigned long long key) {
  return key == kEmpty ? 0 : (int)(unsigned)key;
}

// Block-wide exclusive scan of one flag per thread (blockDim.x <= 1024, a
// multiple of 32): returns this thread's rank among the set flags and the
// block total in *total.  scratch needs 32 ints of shared memory.
__device__ int block_rank(bool flag, int* scratch, int* total) {
  unsigned ballot = __ballot_sync(0xffffffffu, flag);
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = __popc(ballot);
  __syncthreads();
  int off = 0, all = 0;
  int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    int c = scratch[w];
    off += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return off + __popc(ballot & ((1u << lane) - 1u));
}

// Block-wide sum of one int per thread; scratch needs 32 ints.
__device__ int block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int all = 0;
  int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) all += scratch[w];
  __syncthreads();
  return all;
}

// The k smallest of the d distinct global keys at keys[0, d), ascending,
// into keys[0, k) (1 <= k <= kSmemP): an 8-bit MSD radix select finds the
// k-th smallest key, then the k keys up to it are gathered into the shared
// tile and sorted there.  Every thread of the block must call it.
__device__ void select_smallest(unsigned long long* keys, int d, int k,
                                Smem& sm) {
  unsigned long long prefix = 0, mask = 0;
  int want = k;  // rank of the k-th smallest inside the current bucket
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) sm.hist[b] = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < d; t += blockDim.x) {
      unsigned long long key = keys[t];
      if ((key & mask) == prefix) atomicAdd(&sm.hist[(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int b = 0, below = 0;
      while (below + sm.hist[b] < want) below += sm.hist[b++];
      sm.red[0] = b;
      sm.red[1] = below;
    }
    __syncthreads();
    want -= sm.red[1];
    prefix |= (unsigned long long)sm.red[0] << shift;
    mask |= 0xFFULL << shift;
    __syncthreads();
  }
  // keys are distinct, so exactly k of them are <= prefix
  int n = 0;
  for (int t0 = 0; t0 < d; t0 += blockDim.x) {
    int t = t0 + threadIdx.x;
    bool keep = t < d && keys[t] <= prefix;
    int total;
    int at = block_rank(keep, sm.red, &total);
    if (keep && n + at < kSmemP) sm.words[n + at] = keys[t];
    n += total;
  }
  int p = next_pow2(k);
  for (int t = k + threadIdx.x; t < p; t += blockDim.x) sm.words[t] = kEmpty;
  __syncthreads();
  bitonic_sort(sm.words, p);
  for (int t = threadIdx.x; t < k; t += blockDim.x) keys[t] = sm.words[t];
  __syncthreads();
}

// Merges the w candidates in (cv, ci) by column.  Returns d, the number of
// positive group sums; on return keys[0, d) holds rank_key(sum, column) of
// each of them in column order.  ci is clobbered (reused for the group
// sums); cv is read-only.  keys needs next_pow2(w) words; tile is nullptr
// for buffers in shared memory, else the shared words used to sort the
// global keys.  Every thread of the block must call it.
__device__ int merge_groups(const float* cv, int* ci,
                            unsigned long long* keys, int w,
                            unsigned long long* tile, int* red) {
  int p = next_pow2(w > 0 ? w : 1);
  for (int t = threadIdx.x; t < p; t += blockDim.x) {
    keys[t] = t < w ? ((unsigned long long)(unsigned)ci[t] << 32) | (unsigned)t
                    : kEmpty;
  }
  __syncthreads();
  sort_keys(keys, p, tile);
  PW_TICK(2);  // key sort
  // group sums in candidate order at each group's first slot, 0 elsewhere
  float* sums = reinterpret_cast<float*>(ci);
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    unsigned long long kt = keys[t];
    unsigned col = (unsigned)(kt >> 32);
    float s = 0.0f;
    if (t == 0 || (unsigned)(keys[t - 1] >> 32) != col) {
      s = cv[(unsigned)kt];
      for (int u = t + 1; u < w; ++u) {
        unsigned long long ku = keys[u];
        if ((unsigned)(ku >> 32) != col) break;
        s = __fadd_rn(s, cv[(unsigned)ku]);
      }
    }
    sums[t] = s;
  }
  __syncthreads();
  PW_TICK(3);  // group sums
  // compact the positive groups to keys[0, d): a thread reads its own slot
  // before any write of its round, and writes land at or before it
  int d = 0;
  for (int t0 = 0; t0 < w; t0 += blockDim.x) {
    int t = t0 + threadIdx.x;
    float s = t < w ? sums[t] : 0.0f;
    unsigned col = t < w ? (unsigned)(keys[t] >> 32) : 0u;
    bool keep = s > 0.0f;
    int total;
    int at = block_rank(keep, red, &total);
    if (keep) keys[d + at] = rank_key(s, col);
    d += total;
  }
  __syncthreads();
  PW_TICK(4);  // compaction
  return d;
}

// Merges and ranks the w candidates in (cv, ci).  Returns d, the number of
// positive merged entries; on return keys[0, min(d, k_need)) holds the
// first of them in rank order.  Buffers as merge_groups; global says that
// they are global scratch (the shared words are then free for tiles).
// Every thread of the block must call it.
__device__ int compact_block(const float* cv, int* ci,
                             unsigned long long* keys, int w, int k_need,
                             bool global, Smem& sm) {
  unsigned long long* tile = global ? sm.words : nullptr;
  int d = merge_groups(cv, ci, keys, w, tile, sm.red);
  int p2 = next_pow2(d > 0 ? d : 1);
  if (global && p2 > kTile && k_need <= kSmemP) {
    select_smallest(keys, d, min(k_need, d), sm);
    PW_TICK(5);  // select
    return d;
  }
  for (int t = d + threadIdx.x; t < p2; t += blockDim.x) keys[t] = kEmpty;
  __syncthreads();
  sort_keys(keys, p2, tile);
  PW_TICK(5);  // select (a full sort of the groups)
  return d;
}

}  // namespace pw
