// frontier_push: the sparse VERD gather-push with dedup and top-k
// compaction, streamed over frontier-slot chunks.
//
// Replaces the Pallas TPU kernel `frontier_push`
// (src/repro/kernels/frontier_push.py:168, body `_frontier_push_kernel`
// :143), and the streamed fold of `verd.sparse_push_compact`
// (src/repro/core/verd.py:391-486) that the single-device query runs.
//
// Per query row (one block): the running state starts as the wrapper's
// initial candidates; for each chunk of `slots` frontier slots the block
// gathers the real out-edges of every live slot (fv > 0, the first
// min(deg, degree_cap) edges of the CSR row, weight (1-c)*fv/deg) next to
// the running entries -- running first when run_first, else after the
// edges -- and folds them with compact_arrays into the top-k_out running
// state.  The chunk plan (slots per chunk, the padding, the initial
// state) is the wrapper's, identical to the reference's, because every
// fold truncates by rank and the answer depends on the chunk boundaries.
//
// Bound: bytes of col_idx gathered (4 B per real edge of each live slot,
// plus row_ptr/out_deg per slot) and the candidate sort width k_out +
// the chunk's edges.  Design: masked lanes of the TPU's fixed-width
// windows are never gathered (most rmat rows hold ~10 edges, not the hub
// slot width).
//
// One-slot folds (the streamed push of a hub-heavy graph: slot_w is so
// wide that each chunk holds one frontier vertex) are sort-free when the
// wrapper passes the graph's column-sorted CSR view (`Graph.col_sorted`):
// the chunk is the vertex's whole row, every edge carries the same weight
// w, and the view lists the row by (column, offset).  For a row without a
// repeated column (`fast_fold`): each running entry finds its column in
// the sorted row (a search of a shared-memory sample of the row, then of
// one run of it) and adds w once; the new columns all carry w, so they
// rank by column ascending, and the top k_out of them are the first ones
// in the view's order that no running entry hit.  The fold touches
// O(k_out + hits) keys however wide the row, in place of sorting up to
// 2^15.  Its sums are the plain version's (running value first, then the
// chunk's w's), so it is bit-equal on any input.  The running state stays
// in shared memory across consecutive one-slot folds, and the slots' data
// is read kAhead slots at a time: a row's folds run in sequence, so the
// launch takes as long as its slowest row's chain of folds.
//
// Every other fold keeps the general path: a ranked running state plus a
// few edges sorts only the chunk and merges it into the running order
// (merge_fold); the rest run compact_block, in shared memory up to kSmemP
// candidates, hub folds in the row's global scratch with the tiled network
// and radix select of compact.cuh.  That covers multi-slot chunks, the
// one-shot push, rows that repeat a column, and rows cut by degree_cap
// (their chunk is the first budget edges in CSR order, which the sorted
// view does not describe).  Neighbouring threads read neighbouring
// col_idx entries of one row (coalesced).
#include "compact.cuh"

using pw::kEmpty;

// one block per query row; hub folds sort up to 2^15 keys, and two blocks
// of 512 still fit an SM beside each other
constexpr int kThreads = 512;
constexpr int kFoldRun = 1024;   // running entries merge_fold holds
constexpr int kFoldChunk = 512;  // chunk edges merge_fold takes
constexpr int kSample = 512;     // row columns fast_fold samples into smem
constexpr int kAhead = 256;      // one-slot chunks whose data is read at once
static_assert(3 * kFoldRun * 8 + kFoldRun * 4 + 2 * kFoldRun + kSample * 4 <=
                  pw::kTile * 8,
              "fast_fold's buffers must fit the block's shared words");

// The weight (1 - c) * fv / deg of each of a slot's edges, rounded as the
// plain version rounds it.
__device__ __forceinline__ float push_weight(float omc, float f, int deg) {
  return __fmul_rn(__fmul_rn(omc, f),
                   __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f)));
}

// Appends the real out-edges of the chunk's live slots to (cv, ci) from
// position base, in slot order, each weighted (1 - c) * fv / deg rounded
// as the plain version; returns the new end.
__device__ int gather_chunk(const float* fvq, const int* fiq, int c0,
                            int slots, const int* row_ptr, const int* out_deg,
                            const int* col_idx, float omc, int degree_cap,
                            float* cv, int* ci, int base) {
  for (int j = 0; j < slots; ++j) {
    float f = fvq[c0 + j];
    if (!(f > 0.0f)) continue;
    int v = fiq[c0 + j];
    int deg = out_deg[v];
    int budget = min(deg, degree_cap);
    if (budget <= 0) continue;
    int start = row_ptr[v];
    float w = push_weight(omc, f, deg);
    for (int e = threadIdx.x; e < budget; e += blockDim.x) {
      cv[base + e] = w;
      ci[base + e] = col_idx[start + e];
    }
    base += budget;
  }
  return base;
}

// One fold of a ranked running state (n_run <= kFoldRun distinct entries
// in rank order in run_v/run_i) with the chunk's c <= kFoldChunk edges,
// written back to run_v/run_i; returns the new running count.  The result
// is compact_block's over [running, chunk]: each running entry adds the
// chunk's hits on its column in position order, new columns sum their
// hits, and the positive entries rank by rank key.  Only the chunk is
// sorted: running entries the chunk misses keep their order, and one merge
// places them beside the touched and new entries.
__device__ int merge_fold(float* run_v, int* run_i, int n_run, int k_out,
                          int c, const float* fvq, const int* fiq, int c0,
                          int slots, const int* row_ptr, const int* out_deg,
                          const int* col_idx, float omc, int degree_cap,
                          pw::Smem& sm) {
  unsigned long long* rk = sm.words;                 // running keys
  unsigned long long* uk = rk + kFoldRun;            // untouched running
  unsigned long long* xk = uk + kFoldRun;            // touched and new
  unsigned long long* ck = xk + kFoldChunk;          // chunk (column, pos)
  float* cw = reinterpret_cast<float*>(ck + kFoldChunk);
  int* cc = reinterpret_cast<int*>(cw + kFoldChunk);  // columns, then hits

  for (int t = threadIdx.x; t < n_run; t += blockDim.x) {
    rk[t] = pw::rank_key(run_v[t], (unsigned)run_i[t]);
  }
  gather_chunk(fvq, fiq, c0, slots, row_ptr, out_deg, col_idx, omc,
               degree_cap, cw, cc, 0);
  __syncthreads();
  int p = pw::next_pow2(c);
  for (int t = threadIdx.x; t < p; t += blockDim.x) {
    ck[t] = t < c ? ((unsigned long long)(unsigned)cc[t] << 32) | (unsigned)t
                  : kEmpty;
  }
  __syncthreads();
  pw::bitonic_sort(ck, p);
  int* hit_at = cc;  // 1 where a running entry took the chunk group
  for (int t = threadIdx.x; t < c; t += blockDim.x) hit_at[t] = 0;
  __syncthreads();

  int nu = 0, nx = 0, total;
  for (int t0 = 0; t0 < n_run; t0 += blockDim.x) {
    int t = t0 + threadIdx.x;
    bool live = t < n_run;
    unsigned long long key = live ? rk[t] : kEmpty;
    unsigned col = (unsigned)key;
    int at = live ? pw::count_below(ck, c, (unsigned long long)col << 32) : c;
    bool hit = at < c && (unsigned)(ck[at] >> 32) == col;
    if (hit) {
      float v = pw::key_value(key);
      for (int u = at; u < c && (unsigned)(ck[u] >> 32) == col; ++u) {
        v = __fadd_rn(v, cw[(unsigned)ck[u]]);
      }
      hit_at[at] = 1;
      key = pw::rank_key(v, col);
    }
    int r = pw::block_rank(live && !hit, sm.red, &total);
    if (live && !hit) uk[nu + r] = key;
    nu += total;
    r = pw::block_rank(hit, sm.red, &total);
    if (hit) xk[nx + r] = key;
    nx += total;
  }
  __syncthreads();
  for (int t0 = 0; t0 < c; t0 += blockDim.x) {
    int t = t0 + threadIdx.x;
    unsigned col = t < c ? (unsigned)(ck[t] >> 32) : 0u;
    bool lead = t < c && !hit_at[t] &&
                (t == 0 || (unsigned)(ck[t - 1] >> 32) != col);
    float v = 0.0f;
    if (lead) {
      v = cw[(unsigned)ck[t]];
      for (int u = t + 1; u < c && (unsigned)(ck[u] >> 32) == col; ++u) {
        v = __fadd_rn(v, cw[(unsigned)ck[u]]);
      }
    }
    bool keep = lead && v > 0.0f;
    int r = pw::block_rank(keep, sm.red, &total);
    if (keep) xk[nx + r] = pw::rank_key(v, col);
    nx += total;
  }
  int px = pw::next_pow2(nx > 0 ? nx : 1);
  for (int t = nx + threadIdx.x; t < px; t += blockDim.x) xk[t] = kEmpty;
  __syncthreads();
  pw::bitonic_sort(xk, px);
  // keys are distinct: each lands at its rank in the other list plus its own
  for (int t = threadIdx.x; t < nu; t += blockDim.x) {
    int pos = t + pw::count_below(xk, nx, uk[t]);
    if (pos < k_out) {
      run_v[pos] = pw::key_value(uk[t]);
      run_i[pos] = pw::key_column(uk[t]);
    }
  }
  for (int t = threadIdx.x; t < nx; t += blockDim.x) {
    int pos = t + pw::count_below(uk, nu, xk[t]);
    if (pos < k_out) {
      run_v[pos] = pw::key_value(xk[t]);
      run_i[pos] = pw::key_column(xk[t]);
    }
  }
  __syncthreads();
  return min(nu + nx, k_out);
}

// Block-wide exclusive ranks of two flags per thread, with one pair of
// barriers: *ra, *rb this thread's ranks, *ta, *tb the block totals.
// scratch needs 2 * blockDim.x / 32 ints.
__device__ void block_rank2(bool a, bool b, int* scratch, int* ra, int* rb,
                            int* ta, int* tb) {
  const unsigned ba = __ballot_sync(0xffffffffu, a);
  const unsigned bb = __ballot_sync(0xffffffffu, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (lane == 0) {
    scratch[warp] = __popc(ba);
    scratch[warps + warp] = __popc(bb);
  }
  __syncthreads();
  int oa = 0, ob = 0, sa = 0, sb = 0;
  for (int w = 0; w < warps; ++w) {
    const int ca = scratch[w], cb = scratch[warps + w];
    oa += w < warp ? ca : 0;
    ob += w < warp ? cb : 0;
    sa += ca;
    sb += cb;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  *ra = oa + __popc(ba & below);
  *rb = ob + __popc(bb & below);
  *ta = sa;
  *tb = sb;
}

// How many of the n keys at a, in any order, are below key.
__device__ __forceinline__ int count_below_any(const unsigned long long* a,
                                               int n,
                                               unsigned long long key) {
  int c = 0;
  for (int i = 0; i < n; ++i) c += a[i] < key;
  return c;
}

// Position of col in the deg distinct ascending columns at seg, else deg.
// sample[i] = seg[i << shift] for i < ns, in shared memory: the search
// there finds the run of 2^shift columns that can hold col, and only that
// run (one or two lines) is searched in the row itself.
__device__ __forceinline__ int find_column(const int* seg, int deg,
                                           const int* sample, int ns,
                                           int shift, unsigned col) {
  int lo = 0, hi = ns;  // the first sample above col
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((unsigned)sample[mid] <= col) lo = mid + 1; else hi = mid;
  }
  if (lo == 0) return deg;
  const int base = (lo - 1) << shift;
  if ((unsigned)sample[lo - 1] == col) return base;
  int a = base + 1, b = min(base + (1 << shift), deg);
  const int end = b;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if ((unsigned)__ldg(seg + mid) < col) a = mid + 1; else b = mid;
  }
  return a < end && (unsigned)__ldg(seg + a) == col ? a : deg;
}

// One sort-free fold of a vertex's whole row -- deg edges of weight w > 0,
// no column twice, seg its columns ascending (the column-sorted view) --
// into the ranked running keys rk[0, n_run) (n_run <= k_out <= kFoldRun),
// in place; returns the new running count.  Shared words: rk, uk, xk
// (kFoldRun keys each), nc (kFoldRun ints), hit_at (2 kFoldRun bytes) and
// the row's sample (kSample ints), sm.words' 4,096.  The sums are
// compact_block's over [running, row]: a hit running entry is its value
// + w, a new column is w.  Untouched running entries keep their order;
// the new columns all rank at w by column ascending, so the top k_out of
// them are the first ones of seg that no running entry hit, all within
// its first k_out + n_run positions; each key lands at its rank in its
// own list plus its count below in the other two.
__device__ int fast_fold(unsigned long long* words, int n_run, int k_out,
                         const int* seg, int deg, float w, int* red) {
  unsigned long long* rk = words;                    // running keys
  unsigned long long* uk = rk + kFoldRun;            // untouched running
  unsigned long long* xk = uk + kFoldRun;            // hit running
  int* nc = reinterpret_cast<int*>(xk + kFoldRun);   // new columns
  unsigned char* hit_at = reinterpret_cast<unsigned char*>(nc + kFoldRun);
  int* sample = reinterpret_cast<int*>(hit_at + 2 * kFoldRun);
  const int span = min(deg, k_out + n_run);
  for (int p = threadIdx.x; p < span; p += blockDim.x) hit_at[p] = 0;
  int shift = 0;  // a whole row of up to kSample columns is the sample
  while (((deg - 1) >> shift) + 1 > kSample) ++shift;
  const int ns = ((deg - 1) >> shift) + 1;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    sample[i] = __ldg(seg + (i << shift));
  }
  // a row wider than the sample: its first columns, for the new-column
  // scan, are read now, beside the sample
  const int first_col =
      shift > 0 && (int)threadIdx.x < span ? __ldg(seg + threadIdx.x) : 0;
  __syncthreads();

  int nu = 0, nx = 0;
  for (int t0 = 0; t0 < n_run; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool live = t < n_run;
    unsigned long long key = live ? rk[t] : kEmpty;
    const int at =
        live ? find_column(seg, deg, sample, ns, shift, (unsigned)key) : deg;
    const bool hit = at < deg;
    if (hit) key = pw::rank_key(__fadd_rn(pw::key_value(key), w),
                                (unsigned)key);
    int ru, rx, tu, tx;
    block_rank2(live && !hit, hit, red, &ru, &rx, &tu, &tx);
    if (live && !hit) uk[nu + ru] = key;
    if (hit) {
      xk[nx + rx] = key;
      if (at < span) hit_at[at] = 1;
    }
    nu += tu;
    nx += tx;
  }
  __syncthreads();
  int nn = 0;
  for (int p0 = 0; p0 < span && nn < k_out; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool keep = p < span && !hit_at[p];
    int total;
    const int r = pw::block_rank(keep, red, &total);
    if (keep && nn + r < k_out) {
      nc[nn + r] = shift == 0 ? sample[p] : p0 == 0 ? first_col
                                                    : __ldg(seg + p);
    }
    nn += total;
  }
  nn = min(nn, k_out);
  __syncthreads();

  // new keys below a key: none when its value is above w, all when below,
  // else those of a lower column
  const unsigned long long whi = (unsigned long long)(~__float_as_uint(w))
                                 << 32;
  auto new_below = [&](unsigned long long key) -> int {
    const unsigned long long hi = key & 0xFFFFFFFF00000000ULL;
    if (hi != whi) return hi < whi ? 0 : nn;
    const unsigned col = (unsigned)key;
    int lo = 0, up = nn;
    while (lo < up) {
      const int mid = (lo + up) >> 1;
      if ((unsigned)nc[mid] < col) lo = mid + 1; else up = mid;
    }
    return lo;
  };
  for (int t = threadIdx.x; t < nu; t += blockDim.x) {
    const unsigned long long key = uk[t];
    const int pos = t + count_below_any(xk, nx, key) + new_below(key);
    if (pos < k_out) rk[pos] = key;
  }
  for (int t = threadIdx.x; t < nx; t += blockDim.x) {
    const unsigned long long key = xk[t];
    const int pos = count_below_any(xk, nx, key) +
                    pw::count_below(uk, nu, key) + new_below(key);
    if (pos < k_out) rk[pos] = key;
  }
  for (int t = threadIdx.x; t < nn; t += blockDim.x) {
    const unsigned long long key = whi | (unsigned)nc[t];
    const int pos = t + pw::count_below(uk, nu, key) +
                    count_below_any(xk, nx, key);
    if (pos < k_out) rk[pos] = key;
  }
  __syncthreads();
  return min(nu + deg, k_out);  // untouched + hit + (deg - hit) new
}

extern "C" __global__ void __launch_bounds__(kThreads)
frontier_push_kernel(const float* __restrict__ fv, const int* __restrict__ fi,
                     int k, const float* __restrict__ run_v0,
                     const int* __restrict__ run_i0, int r0,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ out_deg,
                     const int* __restrict__ col_idx,
                     const int* __restrict__ sorted_col,
                     const unsigned char* __restrict__ row_repeats,
                     float omc, int degree_cap, int slots, int k_out,
                     int run_first, float* run_v, int* run_i, float* g_cv,
                     int* g_ci, unsigned long long* g_keys, int g_p,
                     float* out_v, int* out_i) {
  __shared__ pw::Smem sm;

  const long long q = blockIdx.x;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;
  float* rvq = run_v + q * k_out;
  int* riq = run_i + q * k_out;
  const float* src_v = run_v0 + q * r0;
  const int* src_i = run_i0 + q * r0;
  int n_run = r0;
  bool ranked = false;  // running state deduplicated and in rank order
  // one-slot folds may go sort-free over the column-sorted view
  const bool fast = sorted_col != nullptr && slots == 1 && run_first &&
                    k_out <= kFoldRun;
  bool in_smem = false;  // the running keys are in sm.words, not rvq/riq

  // Rank the initial state first, so the first fold can be sort-free too.
  // Exact: with no negative value and at most k_out entries, no group of
  // it is truncated, each group sums in the same order, and a group that
  // sums to 0 adds to a chunk hit as nothing (0 + w == w).
  if (fast && r0 <= k_out) {
    int bad = 0;
    for (int t = threadIdx.x; t < r0; t += blockDim.x) {
      bad += !(src_v[t] >= 0.0f);
    }
    if (pw::block_sum(bad, sm.red) == 0) {
      float* cv = sm.cv();
      int* ci = sm.ci();
      for (int t = threadIdx.x; t < r0; t += blockDim.x) {
        cv[t] = src_v[t];
        ci[t] = src_i[t];
      }
      __syncthreads();
      // the ranked keys land at sm.words[0, n_run): fast_fold's rk
      n_run = min(pw::compact_block(cv, ci, sm.keys(), r0, k_out, false, sm),
                  k_out);
      ranked = in_smem = true;
    }
  }

  // the slots' mass, degree, row start and repeat flag, read
  // kAhead at a time (one round of loads, not two dependent ones a fold)
  __shared__ float ahead_f[kAhead];
  __shared__ int ahead_deg[kAhead], ahead_start[kAhead];
  __shared__ bool ahead_repeats[kAhead];
  for (int c0 = 0; c0 < k; c0 += slots) {
    if (fast && c0 % kAhead == 0) {
      __syncthreads();  // every thread is done with the last kAhead
      for (int j = threadIdx.x; j < kAhead && c0 + j < k; j += blockDim.x) {
        const int v = fiq[c0 + j];
        ahead_f[j] = fvq[c0 + j];
        ahead_deg[j] = out_deg[v];
        ahead_start[j] = row_ptr[v];
        ahead_repeats[j] = row_repeats[v] != 0;
      }
      __syncthreads();
    }
    if (fast && ranked) {
      const int j = c0 % kAhead;
      const float f = ahead_f[j];
      if (!(f > 0.0f)) continue;
      const int deg = ahead_deg[j];
      if (min(deg, degree_cap) <= 0) continue;  // folding nothing
      if (deg <= degree_cap && !ahead_repeats[j]) {
        if (!in_smem) {
          for (int t = threadIdx.x; t < n_run; t += blockDim.x) {
            sm.words[t] = pw::rank_key(rvq[t], (unsigned)riq[t]);
          }
          __syncthreads();
          in_smem = true;
        }
        // a weight that rounds to 0 adds 0 to every hit, and new columns
        // of value 0 are dropped: the fold keeps the state
        const float w = push_weight(omc, f, deg);
        if (w > 0.0f) {
          n_run = fast_fold(sm.words, n_run, k_out,
                            sorted_col + ahead_start[j], deg, w, sm.red);
        }
        continue;
      }
    }
    if (in_smem) {  // the general path reads the state from rvq/riq
      for (int t = threadIdx.x; t < n_run; t += blockDim.x) {
        rvq[t] = pw::key_value(sm.words[t]);
        riq[t] = pw::key_column(sm.words[t]);
      }
      __syncthreads();
      src_v = rvq;
      src_i = riq;
      in_smem = false;
    }
    int part = 0;
    for (int j = threadIdx.x; j < slots; j += blockDim.x) {
      if (fvq[c0 + j] > 0.0f) part += min(out_deg[fiq[c0 + j]], degree_cap);
    }
    int c = pw::block_sum(part, sm.red);  // the chunk's real edges
    if (ranked && c == 0) continue;      // folding nothing keeps the state
    if (ranked && run_first && c <= kFoldChunk && n_run <= kFoldRun) {
      n_run = merge_fold(rvq, riq, n_run, k_out, c, fvq, fiq, c0, slots,
                         row_ptr, out_deg, col_idx, omc, degree_cap, sm);
      continue;
    }
    bool smem = n_run + c <= pw::kSmemP;
    float* cv = smem ? sm.cv() : g_cv + q * g_p;
    int* ci = smem ? sm.ci() : g_ci + q * g_p;
    unsigned long long* keys = smem ? sm.keys() : g_keys + q * g_p;

    int base = 0;
    if (run_first) {
      for (int t = threadIdx.x; t < n_run; t += blockDim.x) {
        cv[t] = src_v[t];
        ci[t] = src_i[t];
      }
      base = n_run;
    }
    base = gather_chunk(fvq, fiq, c0, slots, row_ptr, out_deg, col_idx, omc,
                        degree_cap, cv, ci, base);
    if (!run_first) {
      for (int t = threadIdx.x; t < n_run; t += blockDim.x) {
        cv[base + t] = src_v[t];
        ci[base + t] = src_i[t];
      }
      base += n_run;
    }
    __syncthreads();
    int d = pw::compact_block(cv, ci, keys, base, k_out, !smem, sm);

    // the new running state: the top k_out ranked entries
    n_run = min(d, k_out);
    for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
      unsigned long long key = t < n_run ? keys[t] : kEmpty;
      rvq[t] = pw::key_value(key);
      riq[t] = pw::key_column(key);
    }
    __syncthreads();
    src_v = rvq;
    src_i = riq;
    ranked = true;
  }
  float* ovq = out_v + q * k_out;
  int* oiq = out_i + q * k_out;
  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    const bool kept = t < n_run;
    if (in_smem) {
      const unsigned long long key = kept ? sm.words[t] : kEmpty;
      ovq[t] = pw::key_value(key);
      oiq[t] = pw::key_column(key);
    } else {
      ovq[t] = kept ? src_v[t] : 0.0f;
      oiq[t] = kept ? src_i[t] : 0;
    }
  }
}

extern "C" int pw_smem_candidates() { return pw::kSmemP; }

// sorted_col / row_repeats: the graph's column-sorted view (nullptr: no
// sort-free folds).
extern "C" int frontier_push_launch(
    const void* fv, const void* fi, int q, int k, const void* run_v0,
    const void* run_i0, int r0, const void* row_ptr, const void* out_deg,
    const void* col_idx, const void* sorted_col, const void* row_repeats,
    float omc, int degree_cap, int slots, int k_out, int run_first,
    void* run_v, void* run_i, void* g_cv, void* g_ci, void* g_keys, int g_p,
    void* out_v, void* out_i, void* stream) {
  if (q <= 0) return 0;
  frontier_push_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)fi, k, (const float*)run_v0,
      (const int*)run_i0, r0, (const int*)row_ptr, (const int*)out_deg,
      (const int*)col_idx, (const int*)sorted_col,
      (const unsigned char*)row_repeats, omc, degree_cap, slots, k_out,
      run_first,
      (float*)run_v, (int*)run_i, (float*)g_cv, (int*)g_ci,
      (unsigned long long*)g_keys, g_p, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
