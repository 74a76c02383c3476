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
// slot width).  A streamed push is mostly small folds (a ranked running
// state plus a few edges): those sort only the chunk and merge it into the
// running order (merge_fold).  Other folds run compact_block: in shared
// memory up to kSmemP candidates, hub folds in the row's global scratch
// with the tiled network and radix select of compact.cuh.  Neighbouring
// threads read neighbouring col_idx entries of one row (coalesced).
#include "compact.cuh"

using pw::kEmpty;

// one block per query row; hub folds sort up to 2^15 keys, and two blocks
// of 512 still fit an SM beside each other
constexpr int kThreads = 512;
constexpr int kFoldRun = 1024;   // running entries merge_fold holds
constexpr int kFoldChunk = 512;  // chunk edges merge_fold takes

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
    float w = __fmul_rn(__fmul_rn(omc, f),
                        __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f)));
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

extern "C" __global__ void __launch_bounds__(kThreads)
frontier_push_kernel(const float* __restrict__ fv, const int* __restrict__ fi,
                     int k, const float* __restrict__ run_v0,
                     const int* __restrict__ run_i0, int r0,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ out_deg,
                     const int* __restrict__ col_idx, float omc,
                     int degree_cap, int slots, int k_out, int run_first,
                     float* run_v, int* run_i, float* g_cv, int* g_ci,
                     unsigned long long* g_keys, int g_p, float* out_v,
                     int* out_i) {
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

  for (int c0 = 0; c0 < k; c0 += slots) {
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
    bool kept = t < n_run;
    ovq[t] = kept ? src_v[t] : 0.0f;
    oiq[t] = kept ? src_i[t] : 0;
  }
}

extern "C" int pw_smem_candidates() { return pw::kSmemP; }

extern "C" int frontier_push_launch(
    const void* fv, const void* fi, int q, int k, const void* run_v0,
    const void* run_i0, int r0, const void* row_ptr, const void* out_deg,
    const void* col_idx, float omc, int degree_cap, int slots, int k_out,
    int run_first, void* run_v, void* run_i, void* g_cv, void* g_ci,
    void* g_keys, int g_p, void* out_v, void* out_i, void* stream) {
  if (q <= 0) return 0;
  frontier_push_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)fi, k, (const float*)run_v0,
      (const int*)run_i0, r0, (const int*)row_ptr, (const int*)out_deg,
      (const int*)col_idx, omc, degree_cap, slots, k_out, run_first,
      (float*)run_v, (int*)run_i, (float*)g_cv, (int*)g_ci,
      (unsigned long long*)g_keys, g_p, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
