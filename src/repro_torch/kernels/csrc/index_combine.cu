// index_combine_sparse: the final VERD combine (paper Algorithm 4 line 10)
// on sparse state, p = s + sum_v f(v) * P_hat[v], compacted to top-k_out.
//
// Replaces the Pallas TPU kernel `index_combine_sparse`
// (src/repro/kernels/index_combine.py:136, body
// `_index_combine_sparse_kernel` :94), the kernel twin of
// `verd.combine_with_index_sparse` (src/repro/core/verd.py:607).
//
// Candidates of a query row, in candidate order: the S entries of s, then
// for every live frontier slot (fv > 0), in slot order, the positive
// entries of its [L] index row scaled by fv.  Duplicate columns are summed
// in candidate order (__fadd_rn), so the sums are the plain version's;
// groups of positive sum are ranked by (value desc, column asc).
// Zero-mass slots and zero index entries are skipped: they cannot change
// the result for the nonnegative masses PPR works with.
//
// Bound: the bytes of the touched index rows (8 B per entry of each live
// slot's row), ~55 MB at the main path's 256 x 256 slots.  The work is a
// chain of ~100 dependent steps a row (one per live slot), so latency,
// barriers and the re-reads of the parts of a row, not bytes, set the
// time (tools/combine_phases.py splits it by phase).  Two paths:
//
// * hash (k_out <= kHashMaxOut; the main path): a row is spread over P
//   blocks, block p owning the columns whose multiplicative hash falls in
//   part p of [0, 2^32), and each of its 16 warps the columns whose hash
//   continues with the warp's number.  A block reads all of its row's
//   live index rows once (the P blocks of a row run together, so the
//   re-reads hit L2), two batches of units ahead, by bulk copies (the
//   TMA) on mbarriers.  Per batch of 4 units (an index row, or 256
//   entries of s, each) one barrier: before it the threads classify the
//   entries by owner warp; after it each warp gathers its own candidates
//   in candidate order and adds them, without sorting, into a
//   shared-memory open-addressing table (column -> f32 sum) that the warps
//   share.  No two warps touch one sum, so no other barrier orders the
//   adds; a column that comes twice in one warp round is added by its
//   first lane in lane order.  No float atomics: two launches give the
//   same bytes.  The block then radix-selects its top k_out rank keys
//   (per-warp histograms) and sorts them; a second kernel merges the P
//   sorted lists of a row by the same total order.  The wrapper picks P
//   from the host-known worst case S + K * L, and a row takes only as many
//   parts as its own live slots need, so that an evenly hashed row cannot
//   overflow a table; a block whose columns do overflow it splits them
//   further by hash and merges pass by pass, so the result stays exact on
//   any input.
// * sort (wider k_out, or an exact combine with out_k=None): one block
//   per row; the candidates sort by (column, position) in shared memory
//   or in a wrapper-allocated global scratch (compact.cuh), and groups sum
//   serially.
#ifdef PW_PHASE_TIMERS
// Phase timers (built only with -DPW_PHASE_TIMERS): thread 0 of every
// block adds the cycles from the previous mark to this one (after a
// barrier, so a phase ends when its slowest thread does).
__device__ unsigned long long pw_phase_ticks[16];
__device__ unsigned long long pw_phase_blocks[2];
__device__ __forceinline__ void pw_tick(int phase) {
  __shared__ long long pw_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long now = clock64();
    if (phase >= 0) {
      atomicAdd(&pw_phase_ticks[phase], (unsigned long long)(now - pw_last));
    }
    pw_last = now;
  }
}
#define PW_TICK(phase) pw_tick(phase)
// a block of path `which` (0 sort, 1 hash) that walked `units` units
// (live slots; units of the hash path) ends: counted in blocks[which] and
// ticks[7 + 8 * which]
#define PW_COUNT_BLOCK(which, units)                                    \
  if (threadIdx.x == 0) {                                               \
    atomicAdd(&pw_phase_blocks[which], 1ULL);                           \
    atomicAdd(&pw_phase_ticks[7 + 8 * (which)], (unsigned long long)(units)); \
  }
#else
#define PW_COUNT_BLOCK(which, units)
#endif

#include "compact.cuh"
#include "smem_optin.cuh"

using pw::kEmpty;

// -- sort path --------------------------------------------------------------

// one block per query row; its sort steps are wide (up to 2^17 keys), and
// two blocks of 512 still fit an SM beside each other
constexpr int kSortThreads = 512;

extern "C" __global__ void __launch_bounds__(kSortThreads)
index_combine_sort_kernel(const float* __restrict__ sv,
                          const int* __restrict__ si, int s_w,
                          const float* __restrict__ fv,
                          const int* __restrict__ fi, int k,
                          const float* __restrict__ vals,
                          const int* __restrict__ idx, int n, int l,
                          int k_out, float* g_cv, int* g_ci,
                          unsigned long long* g_keys, int g_p,
                          float* out_v, int* out_i) {
  __shared__ pw::Smem sm;
  PW_TICK(-1);

  const long long q = blockIdx.x;
  const float* svq = sv + q * s_w;
  const int* siq = si + q * s_w;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;

  int live = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) live += fvq[j] > 0.0f;
  live = pw::block_sum(live, sm.red);
  int bound = s_w + l * live;
  bool smem = bound <= pw::kSmemP;
  float* cv = smem ? sm.cv() : g_cv + q * g_p;
  int* ci = smem ? sm.ci() : g_ci + q * g_p;
  unsigned long long* keys = smem ? sm.keys() : g_keys + q * g_p;

  for (int t = threadIdx.x; t < s_w; t += blockDim.x) {
    cv[t] = svq[t];
    ci[t] = siq[t];
  }
  PW_TICK(0);  // live count, s
  int base = s_w;
  for (int j = 0; j < k; ++j) {
    float f = fvq[j];
    if (!(f > 0.0f)) continue;
    long long row = min(max(fiq[j], 0), n - 1);
    const float* vrow = vals + row * l;
    const int* irow = idx + row * l;
    for (int e0 = 0; e0 < l; e0 += blockDim.x) {
      int e = e0 + threadIdx.x;
      float v = e < l ? vrow[e] : 0.0f;
      bool keep = v > 0.0f;
      int total;
      int at = pw::block_rank(keep, sm.red, &total);
      if (keep) {
        cv[base + at] = __fmul_rn(f, v);
        ci[base + at] = irow[e];
      }
      base += total;
    }
  }
  __syncthreads();
  PW_TICK(1);  // gather
  int d = pw::compact_block(cv, ci, keys, base, k_out, !smem, sm);

  float* ovq = out_v + q * k_out;
  int* oiq = out_i + q * k_out;
  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    unsigned long long key = t < d ? keys[t] : kEmpty;
    ovq[t] = pw::key_value(key);
    oiq[t] = pw::key_column(key);
  }
  PW_TICK(6);  // write
  PW_COUNT_BLOCK(0, live);
}

extern "C" int pw_smem_candidates() { return pw::kSmemP; }

extern "C" int index_combine_sort_launch(
    const void* sv, const void* si, int q, int s_w, const void* fv,
    const void* fi, int k, const void* vals, const void* idx, int n, int l,
    int k_out, void* g_cv, void* g_ci, void* g_keys, int g_p, void* out_v,
    void* out_i, void* stream) {
  if (q <= 0) return 0;
  index_combine_sort_kernel<<<q, kSortThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sv, (const int*)si, s_w, (const float*)fv,
      (const int*)fi, k, (const float*)vals, (const int*)idx, n, l, k_out,
      (float*)g_cv, (int*)g_ci, (unsigned long long*)g_keys, g_p,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}

// -- hash path --------------------------------------------------------------

constexpr int kWarpBits = 4;
constexpr int kHashWarps = 1 << kWarpBits;      // a block's warps
constexpr int kHashThreads = 32 * kHashWarps;
constexpr int kHashMaxOut = 1024;   // the widest k_out the hash path takes
constexpr int kUnit = 256;          // entries of a unit
constexpr int kGroups = kUnit / 32; // 32-entry groups of a unit
constexpr int kBatch = 4;           // units between two barriers
constexpr int kRingBatches = 3;     // batches staged: one read, two landing
constexpr int kRingUnits = kRingBatches * kBatch;
constexpr int kStage = 64;          // a warp's candidates staged at a time
constexpr unsigned kNoCol = 0xFFFFFFFFu;    // an empty table slot
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kClassifyUnits = kHashThreads / kUnit;  // units a round
static_assert(kBatch * kGroups == 32, "a lane per group of a batch");
static_assert(kHashThreads % kUnit == 0 && kBatch % kClassifyUnits == 0,
              "whole units per classify round");
// block control words
enum { kCount, kOverflow, kBin, kBelow, kBinCount, kTotal, kSel, kCtl };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 bytes from global to shared memory, asynchronously (zeros when
// !valid): only the issuing thread may read them after its own
// cp.async.wait_group (a "memory" clobber keeps its reads below the wait);
// a barrier after that shows them to the block.
__device__ __forceinline__ void copy_async4(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// A bulk copy (the TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) that completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void copy_bulk(void* dst, const void* src,
                                          unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// the one arrival of a phase, which then waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The table slot a column probes first: a mixer independent of the
// partition hash, so one part's columns spread over the whole table.
__device__ __forceinline__ unsigned slot_hash(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The slot of column c, claimed if new.  -1 when c is new and the table
// already holds d_max columns (ctl[kOverflow] is then set).
__device__ __forceinline__ int find_or_claim(unsigned* keys, unsigned c,
                                             int t_log2, int* ctl,
                                             int d_max) {
  const unsigned mask = (1u << t_log2) - 1u;
  unsigned pos = slot_hash(c) >> (32 - t_log2);
  volatile unsigned* vk = keys;
  for (;;) {
    unsigned key = vk[pos];
    if (key == c) return (int)pos;
    if (key == kNoCol) {
      if (*(volatile int*)&ctl[kCount] >= d_max) {
        ctl[kOverflow] = 1;
        return -1;
      }
      unsigned old = atomicCAS(&keys[pos], kNoCol, c);
      if (old == kNoCol) {
        atomicAdd(&ctl[kCount], 1);
        return (int)pos;
      }
      if (old == c) return (int)pos;
    }
    pos = (pos + 1u) & mask;
  }
}

// Adds the kept lanes' values into their columns' sums, the lanes of one
// column in lane (= candidate) order.  Called by the whole warp.
__device__ __forceinline__ void fold_round(bool mine, unsigned kept,
                                           unsigned c, float v,
                                           unsigned* keys, float* sums,
                                           float* scratch, int t_log2,
                                           int* ctl, int d_max, int lane) {
  if (mine) {
    int pos = find_or_claim(keys, c, t_log2, ctl, d_max);
    unsigned grp = __match_any_sync(kept, c);
    if (grp == (1u << lane)) {
      if (pos >= 0) sums[pos] = __fadd_rn(sums[pos], v);
    } else {
      // a column twice in this round: its first lane adds them all
      scratch[lane] = v;
      __syncwarp(grp);
      if (lane == __ffs(grp) - 1 && pos >= 0) {
        float s = sums[pos];
        for (unsigned m = grp; m; m &= m - 1) {
          s = __fadd_rn(s, scratch[__ffs(m) - 1]);
        }
        sums[pos] = s;
      }
      __syncwarp(grp);
    }
  }
  __syncwarp();
}

// Dynamic shared memory of a hash block: two sorted lists of
// next_pow2(k_out) keys, the ring's mbarriers, the table (column and sum:
// 8 B a slot), the staging ring, two batches' owner masks, each warp's
// staged candidates and scratch, the live slots, a histogram and control.
__host__ __device__ inline int hash_smem_bytes(int t_log2, int k,
                                               int k_out) {
  int p2k = 1;
  while (p2k < k_out) p2k <<= 1;
  return 16 * p2k + 32 + 8 * (1 << t_log2) + 8 * kRingUnits * kUnit +
         4 * 2 * kBatch * kGroups * kHashWarps + 8 * kHashWarps * kStage +
         4 * kHashThreads + 8 * k + 4 * (256 + kCtl + 32);
}

// Grid: parts * q blocks, block b = (row b / parts, part b % parts), so a
// row's parts are neighbours in launch order.  A row whose live slots
// bound its candidates to fewer takes only the first parts_row =
// ceil((s_w + live * l) / d_max) of them.  A column's hash is c * part_mul
// mod 2^32 (part_mul odd, the wrapper's PART_MUL); its part is the hash
// times parts_row over 2^32, and warp w owns the part's columns whose hash
// continues with w.  Per batch of kBatch units: the threads
// classify the batch's entries by owner (bit-plane ballots give each owner
// its lanes of a 32-entry group), one barrier, then each warp gathers its
// own candidates of the batch in candidate order and adds them into the
// shared table, while the copies of the two batches ahead land (index
// rows by bulk copies when `bulk`: l % 4 == 0 and 16-byte aligned rows;
// else, and for s, 4 bytes a thread).  No two warps touch one sum, so the
// adds need no other barrier.  Writes the part's top min(k_out, d) rank
// keys, ascending, kEmpty-padded, to part_keys[row][part][0, k_out).
extern "C" __global__ void __launch_bounds__(kHashThreads, 2)
index_combine_hash_kernel(const float* __restrict__ sv,
                          const int* __restrict__ si, int s_w,
                          const float* __restrict__ fv,
                          const int* __restrict__ fi, int k,
                          const float* __restrict__ vals,
                          const int* __restrict__ idx, int n, int l,
                          int k_out, int parts, int t_log2, int d_max,
                          int bulk, unsigned part_mul,
                          unsigned long long* __restrict__ part_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PW_TICK(-1);
  const int tbl = 1 << t_log2;
  const int p2k = pw::next_pow2(k_out);
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* mbar = sel + 2 * p2k;          // [kRingBatches]
  unsigned* keys = reinterpret_cast<unsigned*>(mbar + 4);
  float* sums = reinterpret_cast<float*>(keys + tbl);
  float* ring_v = sums + tbl;                        // [ring units][kUnit]
  unsigned* ring_c = reinterpret_cast<unsigned*>(ring_v + kRingUnits * kUnit);
  unsigned* masks = ring_c + kRingUnits * kUnit;
  unsigned* stage_c = masks + 2 * kBatch * kGroups * kHashWarps;
  float* stage_v = reinterpret_cast<float*>(stage_c + kHashWarps * kStage);
  float* scratch = stage_v + kHashWarps * kStage;    // [warps][32]
  int* live_row = reinterpret_cast<int*>(scratch + kHashThreads);
  float* live_f = reinterpret_cast<float*>(live_row + k);
  int* hist = reinterpret_cast<int*>(live_f + k);    // [256]
  int* ctl = hist + 256;
  int* red = ctl + kCtl;                             // [32]
  int* whist = reinterpret_cast<int*>(ring_v);       // [warps][256], select

  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned warp = (unsigned)t >> 5;
  const long long q = blockIdx.x / parts;
  const int part = blockIdx.x - (int)(q * parts);
  const float* svq = sv + q * s_w;
  const int* siq = si + q * s_w;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;
  unsigned long long* outq = part_keys + (q * parts + part) * k_out;
  unsigned* wstage_c = stage_c + warp * kStage;
  float* wstage_v = stage_v + warp * kStage;
  float* wscratch = scratch + warp * 32;

  // the live slots, in slot order
  int n_live = 0;
  for (int j0 = 0; j0 < k; j0 += kHashThreads) {
    int j = j0 + t;
    float f = j < k ? fvq[j] : 0.0f;
    bool keep = f > 0.0f;
    int total;
    int at = pw::block_rank(keep, red, &total);
    if (keep) {
      live_row[n_live + at] = min(max(fiq[j], 0), n - 1);
      live_f[n_live + at] = f;
    }
    n_live += total;
  }
  if (t == 0) {
    for (int s = 0; s < kRingBatches; ++s) mbar_init(mbar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long bound = s_w + (long long)n_live * l;
  const int parts_row =
      (int)min((long long)parts, max(1LL, (bound + d_max - 1) / d_max));
  if (part >= parts_row) {
    for (int i = t; i < k_out; i += kHashThreads) outq[i] = kEmpty;
    return;
  }
  PW_TICK(8);  // live slots

  // units of kUnit entries: those of s, then each live slot's index row
  const int s_units = (s_w + kUnit - 1) / kUnit;
  const int row_units = (l + kUnit - 1) / kUnit;
  const int n_units = s_units + n_live * row_units;
  const int n_batches = (n_units + kBatch - 1) / kBatch;
  auto slot_of = [&](int u) {  // the live slot of a slot unit
    int r = u - s_units;
    return row_units == 1 ? r : r / row_units;
  };
  auto unit_len = [&](int u) {  // entries of unit u
    int off = (u < s_units ? u : u - s_units - slot_of(u) * row_units) * kUnit;
    return min(kUnit, (u < s_units ? s_w : l) - off);
  };
  // batch b's copies into its ring slot (batch gb of the block, which
  // sets the slot's mbarrier phase); per-thread copies make one commit
  // group; nothing past the last batch.  Entry e of unit i is copied by
  // the thread that classifies it, (i % kClassifyUnits) * kUnit + e, so
  // that thread's own wait_group covers its read of the entry (and the
  // batch barrier after the classify shows the entry to the gather).
  auto copy_batch = [&](int b, int gb) {
    if (b >= n_batches) return;
    const int rs = gb % kRingBatches;
    if (bulk && t == 0) {
      // the phase's bytes first, then the copies that complete them; the
      // slot's last readers passed a barrier before this
      unsigned bytes = 0;
      for (int i = 0; i < kBatch; ++i) {
        const int u = b * kBatch + i;
        if (u < n_units && u >= s_units) bytes += 8u * (unsigned)unit_len(u);
      }
      mbar_expect(mbar + rs, bytes);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    for (int i = 0; i < kBatch; ++i) {
      const int u = b * kBatch + i;
      if (u >= n_units) break;
      float* dv = ring_v + (rs * kBatch + i) * kUnit;
      unsigned* dc = ring_c + (rs * kBatch + i) * kUnit;
      if (u >= s_units && bulk) {
        if (t == 0) {
          int j = slot_of(u);
          int off = (u - s_units - j * row_units) * kUnit;
          const long long src = (long long)live_row[j] * l + off;
          unsigned nb = 4u * (unsigned)unit_len(u);
          copy_bulk(dv, vals + src, nb, mbar + rs);
          copy_bulk(dc, idx + src, nb, mbar + rs);
        }
      } else if (t / kUnit == i % kClassifyUnits) {
        const int te = t % kUnit;
        if (u < s_units) {
          int e = u * kUnit + te;
          bool ok = e < s_w;
          copy_async4(dv + te, ok ? svq + e : svq, ok);
          copy_async4(dc + te, ok ? siq + e : siq, ok);
        } else {
          int j = slot_of(u);
          int e = (u - s_units - j * row_units) * kUnit + te;
          bool ok = e < l;
          long long off = (long long)live_row[j] * l + (ok ? e : 0);
          copy_async4(dv + te, vals + off, ok);
          copy_async4(dc + te, idx + off, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int gbase = 0;  // batches of earlier passes: the mbarriers' phases
  for (int npass_log2 = 0;; ++npass_log2) {
    if (npass_log2 > 26) __trap();  // cannot happen: see the wrapper
    const int npass = 1 << npass_log2;
    bool overflowed = false;
    for (int pass = 0; pass < npass; ++pass) {
      for (int i = t; i < tbl; i += kHashThreads) {
        keys[i] = kNoCol;
        sums[i] = 0.0f;
      }
      if (t == 0) {
        ctl[kCount] = 0;
        ctl[kOverflow] = 0;
      }
      copy_batch(0, gbase);
      copy_batch(1, gbase + 1);
      __syncthreads();

      for (int b = 0; b < n_batches; ++b) {
        const int gb = gbase + b;
        const int rs = gb % kRingBatches;
        if (b + 1 < n_batches) {
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        if (bulk) mbar_wait(mbar + rs, (unsigned)(gb / kRingBatches) & 1u);
        // classify the batch's entries (two units a round) by owner warp,
        // for those that are candidates of this part and pass
        unsigned* mb = masks + (b & 1) * kBatch * kGroups * kHashWarps;
#pragma unroll
        for (int r = 0; r < kBatch / kClassifyUnits; ++r) {
          const int i = r * kClassifyUnits + t / kUnit;
          const int e = t % kUnit;
          const int u = b * kBatch + i;
          unsigned owner = 0;
          bool cand = false;
          if (u < n_units && e < unit_len(u)) {
            const int at = (rs * kBatch + i) * kUnit + e;
            float x = ring_v[at];
            unsigned c = ring_c[at];
            if ((u < s_units ? x != 0.0f : x > 0.0f) && c != kNoCol) {
              unsigned long long xx =
                  (unsigned long long)(c * part_mul) * (unsigned)parts_row;
              unsigned frac = (unsigned)xx;
              cand = (int)(xx >> 32) == part &&
                     (npass_log2 == 0 ||
                      (int)((frac << kWarpBits) >> (32 - npass_log2)) == pass);
              owner = frac >> (32 - kWarpBits);
            }
          }
          unsigned lanes = __ballot_sync(kFull, cand);
#pragma unroll
          for (int bit = 0; bit < kWarpBits; ++bit) {
            unsigned plane = __ballot_sync(kFull, (owner >> bit) & 1u);
            lanes &= (lane >> bit) & 1 ? plane : ~plane;
          }
          if (lane < kHashWarps) {
            const int grp = e / 32;
            mb[(i * kGroups + grp) * kHashWarps + lane] = lanes;
          }
        }
        __syncthreads();
        // the ring slot batch b + 2 takes was read before this barrier
        copy_batch(b + 2, gb + 2);
        // gather this warp's candidates of the batch, in candidate order:
        // lane L reads group L (unit L / kGroups, entries 32 (L % kGroups)
        // on) and places its entries after those of the lanes before it
        const unsigned m = mb[lane * kHashWarps + warp];
        const int cnt = __popc(m);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        const int u = b * kBatch + lane / kGroups;
        const int base = (rs * kBatch + lane / kGroups) * kUnit +
                         32 * (lane % kGroups);
        const float f =
            u >= s_units && u < n_units ? live_f[slot_of(u)] : 1.0f;
        for (int w0 = 0; w0 < total; w0 += kStage) {
          int o = incl - cnt;
          for (unsigned mm = m; mm; mm &= mm - 1, ++o) {
            if (o >= w0 && o < w0 + kStage) {
              const int e = base + __ffs(mm) - 1;
              float x = ring_v[e];
              wstage_c[o - w0] = ring_c[e];
              wstage_v[o - w0] = u < s_units ? x : __fmul_rn(f, x);
            }
          }
          __syncwarp();
          const int nwin = min(kStage, total - w0);
          for (int r0 = 0; r0 < nwin; r0 += 32) {
            const bool mine = r0 + lane < nwin;
            const unsigned c = mine ? wstage_c[r0 + lane] : kNoCol;
            const float v = mine ? wstage_v[r0 + lane] : 0.0f;
            fold_round(mine, __ballot_sync(kFull, mine), c, v, keys, sums,
                       wscratch, t_log2, ctl, d_max, lane);
          }
        }
      }
      gbase += n_batches;
      __syncthreads();
      overflowed = ctl[kOverflow] != 0;
      __syncthreads();
      PW_TICK(9);  // merge (gather, probe, sum)
      if (overflowed) break;

      // -- select this pass's top min(k_out, d) rank keys ------------------
      // MSD radix select of the kk-th smallest rank key, 8 bits a pass
      // (per-warp histograms in the idle ring); the first pass counts d;
      // stops once the bucket holding it is taken whole
      unsigned long long prefix = 0, mask = 0;
      int want = k_out;
      int kk = k_out;
      for (int shift = 56; shift >= 0; shift -= 8) {
        for (int b = t; b < kHashWarps * 256; b += kHashThreads) whist[b] = 0;
        __syncthreads();
        for (int i = t; i < tbl; i += kHashThreads) {
          unsigned col = keys[i];
          float s = sums[i];
          if (col != kNoCol && s > 0.0f) {
            unsigned long long rk = pw::rank_key(s, col);
            if ((rk & mask) == prefix) {
              atomicAdd(&whist[warp * 256 + ((unsigned)(rk >> shift) & 255u)],
                        1);
            }
          }
        }
        __syncthreads();
        if (t < 256) {
          int sum = 0;
#pragma unroll
          for (int w = 0; w < kHashWarps; ++w) sum += whist[w * 256 + t];
          hist[t] = sum;
        }
        __syncthreads();
        if (t < 32) {
          int cnt[8];
          int sum = 0;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            cnt[b] = hist[lane * 8 + b];
            sum += cnt[b];
          }
          int incl = sum;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          if (lane == 31) ctl[kTotal] = incl;
          int below = incl - sum;
          if (below < want && want <= incl) {
            int b = 0;
#pragma unroll
            for (int bb = 0; bb < 7; ++bb) {
              if (b == bb && below + cnt[bb] < want) {
                below += cnt[bb];
                b = bb + 1;
              }
            }
            int in_bin = 0;
#pragma unroll
            for (int bb = 0; bb < 8; ++bb) in_bin = b == bb ? cnt[bb] : in_bin;
            ctl[kBin] = lane * 8 + b;
            ctl[kBelow] = below;
            ctl[kBinCount] = in_bin;
          }
        }
        __syncthreads();
        if (shift == 56 && ctl[kTotal] <= k_out) {
          kk = ctl[kTotal];  // every positive sum is taken
          break;
        }
        want -= ctl[kBelow];
        const int bin_count = ctl[kBinCount];
        prefix |= (unsigned long long)ctl[kBin] << shift;
        mask |= 0xFFULL << shift;
        __syncthreads();
        if (bin_count == want) break;  // the whole bucket is taken
      }
      // the kk selected keys, sorted
      const int p2 = pw::next_pow2(kk > 0 ? kk : 1);
      if (t == 0) ctl[kSel] = 0;
      __syncthreads();
      for (int i = t; i < tbl; i += kHashThreads) {
        unsigned col = keys[i];
        float s = sums[i];
        if (col != kNoCol && s > 0.0f) {
          unsigned long long rk = pw::rank_key(s, col);
          if ((rk & mask) <= prefix) sel[atomicAdd(&ctl[kSel], 1)] = rk;
        }
      }
      __syncthreads();
      for (int i = kk + t; i < p2; i += kHashThreads) sel[i] = kEmpty;
      __syncthreads();
      pw::bitonic_sort(sel, p2);
      if (pass == 0) {
        for (int i = t; i < k_out; i += kHashThreads) {
          outq[i] = i < kk ? sel[i] : kEmpty;
        }
      } else {
        // merge with the earlier passes' list (disjoint columns)
        unsigned long long* merged = sel + p2k;
        for (int i = t; i < k_out; i += kHashThreads) merged[i] = kEmpty;
        __syncthreads();
        const int r_n = pw::count_below(outq, k_out, kEmpty);
        for (int i = t; i < kk; i += kHashThreads) {
          int rank = i + pw::count_below(outq, r_n, sel[i]);
          if (rank < k_out) merged[rank] = sel[i];
        }
        for (int i = t; i < r_n; i += kHashThreads) {
          int rank = i + pw::count_below(sel, kk, outq[i]);
          if (rank < k_out) merged[rank] = outq[i];
        }
        __syncthreads();
        for (int i = t; i < k_out; i += kHashThreads) outq[i] = merged[i];
      }
      __syncthreads();
      PW_TICK(10);  // select
    }
    if (!overflowed) break;
  }
  PW_COUNT_BLOCK(1, n_units);
}

// One block per row: the rank of each key of the row's parts lists is its
// index in its own list plus the keys below it in the others.
extern "C" __global__ void __launch_bounds__(256)
index_combine_merge_kernel(const unsigned long long* __restrict__ part_keys,
                           int parts, int k_out, float* out_v, int* out_i) {
  const long long q = blockIdx.x;
  const unsigned long long* lists = part_keys + q * parts * k_out;
  float* ovq = out_v + q * k_out;
  int* oiq = out_i + q * k_out;
  int total = 0;
  for (int o = 0; o < parts; ++o) {
    total += pw::count_below(lists + (long long)o * k_out, k_out, kEmpty);
  }
  for (int e = threadIdx.x; e < parts * k_out; e += blockDim.x) {
    unsigned long long key = lists[e];
    if (key == kEmpty) continue;
    int own = e / k_out;
    int rank = e - own * k_out;
    for (int o = 0; o < parts && rank < k_out; ++o) {
      if (o != own) {
        rank += pw::count_below(lists + (long long)o * k_out, k_out, key);
      }
    }
    if (rank < k_out) {
      ovq[rank] = pw::key_value(key);
      oiq[rank] = pw::key_column(key);
    }
  }
  for (int r = min(total, k_out) + threadIdx.x; r < k_out; r += blockDim.x) {
    ovq[r] = 0.0f;
    oiq[r] = 0;
  }
}

// The dynamic shared memory of a hash block, or -1 when the hash path does
// not take k_out (the wrapper's plan reads it: one source for the layout).
extern "C" int index_combine_hash_smem(int t_log2, int k, int k_out) {
  return k_out > kHashMaxOut ? -1 : hash_smem_bytes(t_log2, k, k_out);
}

extern "C" int index_combine_hash_launch(
    const void* sv, const void* si, int q, int s_w, const void* fv,
    const void* fi, int k, const void* vals, const void* idx, int n, int l,
    int k_out, int parts, int t_log2, int d_max, int bulk, unsigned part_mul,
    void* part_keys, void* out_v, void* out_i, void* stream) {
  if (q <= 0) return 0;
  // a table needs a free slot for every claim in flight past d_max (one a
  // thread), and the partition hash an odd multiplier (a bijection)
  if (k_out > kHashMaxOut || d_max < 1 ||
      d_max > 3 * (1 << t_log2) / 4 - kHashThreads || (part_mul & 1u) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  static int smem_done[pw::kMaxDevices];
  const int smem_err = pw::once_per_device(smem_done, [] {
    return pw::allow_max_dynamic_smem(index_combine_hash_kernel);
  });
  if (smem_err) return smem_err;
  const int smem = hash_smem_bytes(t_log2, k, k_out);
  cudaStream_t st = (cudaStream_t)stream;
  index_combine_hash_kernel<<<(unsigned)q * parts, kHashThreads, smem, st>>>(
      (const float*)sv, (const int*)si, s_w, (const float*)fv,
      (const int*)fi, k, (const float*)vals, (const int*)idx, n, l, k_out,
      parts, t_log2, d_max, bulk, part_mul, (unsigned long long*)part_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  index_combine_merge_kernel<<<q, 256, 0, st>>>(
      (const unsigned long long*)part_keys, parts, k_out, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}

#ifdef PW_PHASE_TIMERS
extern "C" int pw_phase_timers_reset() {
  unsigned long long zero[16] = {0};
  cudaError_t err = cudaMemcpyToSymbol(pw_phase_ticks, zero, sizeof(zero));
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(pw_phase_blocks, zero, 2 * sizeof(zero[0]));
  }
  return (int)err;
}

// ticks[16] (cycles summed over blocks, by phase), then blocks[2] (sort,
// hash)
extern "C" int pw_phase_timers_read(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, pw_phase_ticks,
                                         16 * sizeof(host[0]));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(host + 16, pw_phase_blocks,
                               2 * sizeof(host[0]));
  }
  return (int)err;
}
#endif
