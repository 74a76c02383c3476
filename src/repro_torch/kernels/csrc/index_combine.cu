// index_combine_sparse: the final VERD combine (paper Algorithm 4 line 10)
// on sparse state, p = s + sum_v f(v) * P_hat[v], compacted to top-k_out.
//
// Replaces the Pallas TPU kernel `index_combine_sparse`
// (src/repro/kernels/index_combine.py:136, body
// `_index_combine_sparse_kernel` :94), the kernel twin of
// `verd.combine_with_index_sparse` (src/repro/core/verd.py:607).
//
// Per query row (one block): the S entries of s, then for every live
// frontier slot (fv > 0) the positive entries of its [L] index row scaled
// by fv, in slot order; then the shared dedup + rank of compact.cuh.
//
// Bound: bytes of index rows gathered (8 B per entry of each touched row,
// K * L * 8 B per query) and the candidate sort width S + K * L (~66k at
// K = L = 256).  Design: zero-mass slots and zero-padded index entries are
// skipped (a block-wide ballot keeps the survivors in candidate order, so
// duplicate columns are summed in the plain version's order); each row is
// read with neighbouring threads on neighbouring entries; the wide rows
// sort in the row's slice of a wrapper-allocated global scratch, since 66k
// candidates (16 B each) exceed the 227 KB of shared memory, with the
// tiled network of compact.cuh (steps of compare distance < 4096 run in a
// shared-memory tile).
#include "compact.cuh"

using pw::kEmpty;

// one block per query row; its sort steps are wide (up to 2^17 keys), and
// two blocks of 512 still fit an SM beside each other
constexpr int kThreads = 512;

extern "C" __global__ void __launch_bounds__(kThreads)
index_combine_sparse_kernel(const float* __restrict__ sv,
                            const int* __restrict__ si, int s_w,
                            const float* __restrict__ fv,
                            const int* __restrict__ fi, int k,
                            const float* __restrict__ vals,
                            const int* __restrict__ idx, int n, int l,
                            int k_out, float* g_cv, int* g_ci,
                            unsigned long long* g_keys, int g_p,
                            float* out_v, int* out_i) {
  __shared__ pw::Smem sm;

  const long long q = blockIdx.x;
  const float* svq = sv + q * s_w;
  const int* siq = si + q * s_w;
  const float* fvq = fv + q * k;
  const int* fiq = fi + q * k;

  int live = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) live += fvq[j] > 0.0f;
  int bound = s_w + l * pw::block_sum(live, sm.red);
  bool smem = bound <= pw::kSmemP;
  float* cv = smem ? sm.cv() : g_cv + q * g_p;
  int* ci = smem ? sm.ci() : g_ci + q * g_p;
  unsigned long long* keys = smem ? sm.keys() : g_keys + q * g_p;

  for (int t = threadIdx.x; t < s_w; t += blockDim.x) {
    cv[t] = svq[t];
    ci[t] = siq[t];
  }
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
  int d = pw::compact_block(cv, ci, keys, base, k_out, !smem, sm);

  float* ovq = out_v + q * k_out;
  int* oiq = out_i + q * k_out;
  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    unsigned long long key = t < d ? keys[t] : kEmpty;
    ovq[t] = pw::key_value(key);
    oiq[t] = pw::key_column(key);
  }
}

extern "C" int pw_smem_candidates() { return pw::kSmemP; }

extern "C" int index_combine_sparse_launch(
    const void* sv, const void* si, int q, int s_w, const void* fv,
    const void* fi, int k, const void* vals, const void* idx, int n, int l,
    int k_out, void* g_cv, void* g_ci, void* g_keys, int g_p, void* out_v,
    void* out_i, void* stream) {
  if (q <= 0) return 0;
  index_combine_sparse_kernel<<<q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sv, (const int*)si, s_w, (const float*)fv,
      (const int*)fi, k, (const float*)vals, (const int*)idx, n, l, k_out,
      (float*)g_cv, (int*)g_ci, (unsigned long long*)g_keys, g_p,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
