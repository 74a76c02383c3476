// embedding_bag_backward: the table gradient of the bag-sum lookup.
//
// Stands for the transpose of the reference's gather
// (src/repro/models/recsys/embedding.py:56, `jnp.take` of the cast table),
// which XLA computes as a scatter-add; the forward is the port of the
// Pallas kernel `embedding_bag` (src/repro/kernels/embedding_bag.py:40).
//
//   grad_table[v, :] = sum over slots s = (r, i) with ids[r, i] == v, in
//                      slot order, of round(grad_out[r, :] * mask[r, i])
//
// with `round` the identity or a round to bf16 (the row dtype the forward
// rounded the gathered rows to), and the running sum rounded to the row
// dtype after every add: XLA's scatter adds bf16 updates into a bf16 zero
// table one at a time.  A null mask is a weight of one.  The sum is stored
// as f32; a row no slot hits is +0.0.
//
// The wrapper sorts the slots by id, stably (`torch.sort`), so each run of
// equal ids is contiguous and in slot order; ids outside the table carry
// the key `vocab` and sort last, where no tile reads them.
//
// Bound: bytes.  The whole [vocab, D] f32 gradient is written once (autograd
// wants it dense: 6.66 GB at DLRM's train step, against 0.22 GB of
// grad_out), grad_out read once, the keys, the order and the mask once a
// slot.  Design:
//
// - One pass over the gradient's rows, the zero fill fused.  The rows are
//   cut into tiles of `rows_per_tile` contiguous rows (a few tens of KB of
//   output); a small pre-pass kernel (`embedding_bag_backward_starts`)
//   writes each tile's first sorted position by a binary search over the
//   keys.  Persistent warps take tiles with a grid stride; a warp sums its
//   tile's runs, marks the rows they hit in a byte map in shared memory, and
//   writes every other row of the tile as +0.0 with contiguous 16-byte
//   streaming stores (8 or 4 bytes where D does not divide).  Every row is
//   written exactly once, by one warp; nothing fills the gradient first.
// - Several runs a warp, wide vectors.  A warp stages 32 sorted positions at
//   a time (keys and order in one coalesced load each, run starts by
//   __ballot_sync) in shared memory and splits them among groups of
//   `lanes_per_row` lanes, each at VEC gradient elements a load (16 bytes
//   where D and the pointer allow: 8 lanes a row at D = 64 in bf16, 2 at
//   D = 16; a whole warp, in up to P vectors a lane, at D = 576).  A group
//   takes the positions from the first run start in its share of the 32 to
//   the first run start in the next group's, so each run is summed by one
//   group, in slot order; a run still open at the end of the 32 passes to
//   the first group of the next 32 with __shfl_sync.
// - Loads in flight.  The next 32 positions' keys and order are loaded
//   while this batch's rows are read; a group issues the row loads of up to
//   kU slots before the first add, so only the adds wait on each other.
//   Slot arithmetic is 32-bit (the wrapper refuses 2**31 - 64 slots or more)
//   and skips the division by `bag` where bag == 1.
//
// No atomics: every element of the gradient is written by one lane, and a
// run's sum is taken in slot order with __fmul_rn / __fadd_rn (nothing is
// contracted into an fma), so the plain version is reproduced bit for bit
// and two launches give the same bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;            // warps a block
constexpr int kBatch = 32;           // sorted positions a warp stages at once
constexpr int kMaxTileRows = 1024;   // rows a tile: a warp's byte map
constexpr int kStartThreads = 256;   // threads a block of the pre-pass
constexpr unsigned kAll = 0xffffffffu;

// The pre-pass: starts[t] = the first sorted position whose key is at least
// min(t * rows_per_tile, vocab), for t in [0, n_tiles]; starts[n_tiles] is
// then the count of live slots.
__global__ void embedding_bag_backward_starts(const int* __restrict__ keys,
                                              int slots, int vocab,
                                              int rows_per_tile, int n_tiles,
                                              int* __restrict__ starts) {
  const int t = blockIdx.x * kStartThreads + threadIdx.x;
  if (t > n_tiles) return;
  const long long target =
      min((long long)t * rows_per_tile, (long long)vocab);
  int lo = 0, hi = slots;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  starts[t] = lo;
}

// BYTES of a gradient row in one load, as 32-bit words.
template <int BYTES>
__device__ __forceinline__ void load_raw(const void* p, unsigned* w) {
  if constexpr (BYTES == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else if constexpr (BYTES == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Element e of a loaded vector, widened to f32 (bf16 -> f32 is exact).
template <typename G>
__device__ __forceinline__ float element(const unsigned* w, int e) {
  if constexpr (std::is_same<G, float>::value) {
    return __uint_as_float(w[e]);
  } else {
    const unsigned x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* a) {
  if constexpr (N == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(a[4], a[5], a[6], a[7]));
  } else if constexpr (N == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (N == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    __stcs(p, a[0]);
  }
}

// Writes +0.0 to every granule of ZW floats of the tile (`total` floats
// from `base`, rows of d) whose row the byte map `hit` does not mark.  A lane
// starts at granule `lane` (row `row`, column `col`) and steps 32 granules
// (`step_r` rows and `step_c` columns) at a time, so no division per store.
template <int ZW>
__device__ __forceinline__ void zero_fill(float* base, int total, int d,
                                          const unsigned char* hit, int lane,
                                          int row, int col, int step_r,
                                          int step_c) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = lane * ZW; e < total; e += kBatch * ZW) {
    if (!hit[row]) store<ZW>(base + e, zero);
    col += step_c;
    row += step_r;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
}

// A run's sum, this lane's share of it: vectors cb + li + j * lanes of the
// row at `row` (those below nv).
template <int VEC, int P>
__device__ __forceinline__ void store_run(float* row,
                                          const float (&acc)[P][VEC], int cb,
                                          int li, int lanes_log2, int nv) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int vi = cb + li + (j << lanes_log2);
    if (vi < nv) store<VEC>(row + vi * VEC, acc[j]);
  }
}

// One group's share [c0, c1) of a staged batch: the row loads of up to kU
// positions, then their adds in order, a run that ends inside the share
// stored as the next one starts.  `run` (its row in the tile) and `acc`
// carry the open run in and out.  kTrain fixes the train cells' case (no
// mask, sums rounded to bf16) at compile time, so that copy of the add
// loop holds no branch on them; the other copy reads `masked` and
// `rounded`.  (Four fixed copies measured slower at DLRM's and DCN-v2's
// shapes, PERF.md.)
template <typename G, int VEC, int P, bool kTrain>
__device__ __forceinline__ void sum_share(
    const G* __restrict__ grad_out, float* __restrict__ grad_table,
    const int* row_of, const int* key_of, const float* w_of,
    unsigned run_starts, int c0, int c1, int cb, int li, int lanes_log2,
    int nv, int d, int r0, float (&acc)[P][VEC], int& run, bool masked,
    bool rounded) {
  const bool with_mask = kTrain ? false : masked;
  const bool to_bf16 = kTrain ? true : rounded;
  constexpr int kWords = (VEC * (int)sizeof(G) + 3) / 4;  // words a vector
  constexpr int kU = 32 / (P * kWords);  // slots a group loads at once
  for (int c = c0; c < c1; c += kU) {
    unsigned v[kU][P][kWords];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c + u < c1) {
        const G* src = grad_out + (size_t)row_of[c + u] * d;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int vi = cb + li + (j << lanes_log2);
          if (vi < nv) load_raw<VEC * (int)sizeof(G)>(src + vi * VEC, v[u][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = c + u;
      if (q >= c1) break;
      if ((run_starts >> q) & 1u) {
        if (run >= 0)  // the run before this one, in this group
          store_run(grad_table + (size_t)(r0 + run) * d, acc, cb, li,
                    lanes_log2, nv);
        run = key_of[q];
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
      }
      const float w = with_mask ? w_of[q] : 1.0f;
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float x = element<G>(v[u][j], e);
          if (with_mask) x = __fmul_rn(x, w);
          if (to_bf16) x = round_bf16(x);
          const float y = __fadd_rn(acc[j][e], x);
          acc[j][e] = to_bf16 ? round_bf16(y) : y;
        }
    }
  }
}

// G: grad_out's element type; VEC: elements a load; P: vectors a lane covers
// of a row in one column block (1, or 4 for rows wider than a warp's loads).
template <typename G, int VEC, int P>
__global__ void __launch_bounds__(kWarps * 32) embedding_bag_backward_tiles(
    const int* __restrict__ keys, const long long* __restrict__ order,
    const float* __restrict__ mask, const G* __restrict__ grad_out,
    const int* __restrict__ starts, int bag, int vocab, int d,
    int rows_per_tile, int n_tiles, int lanes_log2, int round_rows,
    float* __restrict__ grad_table) {
  __shared__ int s_row[kWarps][kBatch];   // grad_out row of a position
  __shared__ int s_key[kWarps][kBatch];   // its gradient row in the tile
  __shared__ float s_w[kWarps][kBatch];   // its weight
  __shared__ __align__(16) unsigned char s_hit[kWarps][kMaxTileRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int gi = lane >> lanes_log2, li = lane & (lanes - 1);
  const int nv = d / VEC;                                 // vectors a row
  const int block_v = P << lanes_log2;                    // vectors a block
  const bool round_sums = round_rows != 0;
  const int zw = d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1;
  const int zrow = lane * zw / d, zcol = lane * zw % d;
  const int zstep_r = kBatch * zw / d, zstep_c = kBatch * zw % d;
  unsigned char* hit = s_hit[warp];

  for (int tile = blockIdx.x * kWarps + warp; tile < n_tiles;
       tile += gridDim.x * kWarps) {
    const int r0 = tile * rows_per_tile;
    const int nrows = min(rows_per_tile, vocab - r0);
    const int lo = starts[tile], hi = starts[tile + 1];
    for (int i = lane; i * 4 < nrows; i += kBatch)
      reinterpret_cast<unsigned*>(hit)[i] = 0u;
    __syncwarp();
    for (int cb = 0; cb < nv; cb += block_v) {
      float acc[P][VEC];
      int run = -1;     // the group's open run: its row in the tile
      int carry = -1;   // the group holding a run open past the last batch
      int prev = -1;    // the key of the last batch's last position
      int k_next = -1;
      long long o_next = 0;
      if (lane < hi - lo) {
        k_next = keys[lo + lane];
        o_next = order[lo + lane];
      }
      for (int p0 = lo; p0 < hi; p0 += kBatch) {
        const int n = min(kBatch, hi - p0);
        const int k = k_next;
        const int s = (int)o_next;
        k_next = -1;
        if (lane < hi - p0 - kBatch) {  // the next batch, in flight
          k_next = keys[p0 + kBatch + lane];
          o_next = order[p0 + kBatch + lane];
        }
        int up = __shfl_up_sync(kAll, k, 1);
        if (lane == 0) up = prev;
        const unsigned run_starts = __ballot_sync(kAll, lane < n && k != up);
        prev = __shfl_sync(kAll, k, n - 1);
        __syncwarp();  // every group is done with the last batch's stage
        if (lane < n) {
          s_row[warp][lane] = bag == 1 ? s : s / bag;
          s_key[warp][lane] = k - r0;
          if (mask) s_w[warp][lane] = mask[s];
          hit[k - r0] = 1;  // lanes of one run store the same byte
        }
        __syncwarp();
        if (carry >= 0) {  // the run left open by the last batch
          if (run_starts & 1u) {        // ended with it: its group stores it
            if (gi == carry) {
              store_run(grad_table + (size_t)(r0 + run) * d, acc, cb, li,
                        lanes_log2, nv);
              run = -1;
            }
          } else {                      // goes on: group 0 takes it
            const int src = (carry << lanes_log2) | li;
#pragma unroll
            for (int j = 0; j < P; ++j)
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const float x = __shfl_sync(kAll, acc[j][e], src);
                if (gi == 0) acc[j][e] = x;
              }
            const int r = __shfl_sync(kAll, run, src);
            run = gi == 0 ? r : -1;
          }
        }
        // this group's positions: from the first run start at or after
        // gi * lanes (0 for group 0, which may continue a run) to the first
        // at or after (gi + 1) * lanes
        const int a = gi << lanes_log2, b = (gi + 1) << lanes_log2;
        const unsigned from_a = a < kBatch ? run_starts & (kAll << a) : 0u;
        const unsigned from_b = b < kBatch ? run_starts & (kAll << b) : 0u;
        const int c0 = gi == 0 ? 0 : from_a ? __ffs(from_a) - 1 : n;
        const int c1 = from_b ? __ffs(from_b) - 1 : n;
        const int* row_of = s_row[warp];
        const int* key_of = s_key[warp];
        const float* w_of = s_w[warp];
        if (mask == nullptr && round_sums)
          sum_share<G, VEC, P, true>(grad_out, grad_table, row_of, key_of,
                                     w_of, run_starts, c0, c1, cb, li,
                                     lanes_log2, nv, d, r0, acc, run, false,
                                     true);
        else
          sum_share<G, VEC, P, false>(grad_out, grad_table, row_of, key_of,
                                      w_of, run_starts, c0, c1, cb, li,
                                      lanes_log2, nv, d, r0, acc, run,
                                      mask != nullptr, round_sums);
        // a group's last run stays open only where the next batch may go
        // on with it: the group holding the batch's last position
        const int holder = (run_starts ? 31 - __clz(run_starts) : 0)
                           >> lanes_log2;
        const bool more = n == kBatch && p0 + kBatch < hi;
        if (run >= 0 && !(more && gi == holder)) {
          store_run(grad_table + (size_t)(r0 + run) * d, acc, cb, li,
                    lanes_log2, nv);
          run = -1;
        }
        carry = more ? holder : -1;
      }
    }
    __syncwarp();  // the byte map is complete
    float* base = grad_table + (size_t)r0 * d;
    const int total = nrows * d;
    if (zw == 4)
      zero_fill<4>(base, total, d, hit, lane, zrow, zcol, zstep_r, zstep_c);
    else if (zw == 2)
      zero_fill<2>(base, total, d, hit, lane, zrow, zcol, zstep_r, zstep_c);
    else
      zero_fill<1>(base, total, d, hit, lane, zrow, zcol, zstep_r, zstep_c);
    __syncwarp();  // every lane has read the byte map before the next tile
  }
}

template <typename G, int VEC, int P>
struct Launcher {
  static const void* kernel() {
    return (const void*)embedding_bag_backward_tiles<G, VEC, P>;
  }
  static void launch(const int* keys, const long long* order,
                     const float* mask, const void* grad_out,
                     const int* starts, int bag, int vocab, int d,
                     int rows_per_tile, int n_tiles, int lanes_log2,
                     int round_rows, int blocks, float* out, cudaStream_t s) {
    embedding_bag_backward_tiles<G, VEC, P><<<blocks, kWarps * 32, 0, s>>>(
        keys, order, mask, (const G*)grad_out, starts, bag, vocab, d,
        rows_per_tile, n_tiles, lanes_log2, round_rows, out);
  }
};

template <typename G, int VEC, typename Fn>
int by_passes(int passes, Fn fn) {
  if (passes == 1) return fn(Launcher<G, VEC, 1>());
  if (passes == 4) return fn(Launcher<G, VEC, 4>());
  return (int)cudaErrorInvalidValue;
}

// Calls fn(Launcher<...>()) for the runtime variant, or returns
// cudaErrorInvalidValue for one that is not compiled.
template <typename Fn>
int dispatch(int grad_bf16, int vec, int passes, Fn fn) {
  if (grad_bf16) {
    if (vec == 8) return by_passes<__nv_bfloat16, 8>(passes, fn);
    if (vec == 4) return by_passes<__nv_bfloat16, 4>(passes, fn);
    if (vec == 2) return by_passes<__nv_bfloat16, 2>(passes, fn);
    if (vec == 1) return by_passes<__nv_bfloat16, 1>(passes, fn);
  } else {
    if (vec == 4) return by_passes<float, 4>(passes, fn);
    if (vec == 2) return by_passes<float, 2>(passes, fn);
    if (vec == 1) return by_passes<float, 1>(passes, fn);
  }
  return (int)cudaErrorInvalidValue;
}

int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

}  // namespace

// Resident blocks an SM of the current device holds for one variant
// (gradient dtype, vec, passes): the wrapper sizes the persistent grid from
// it.
extern "C" int embedding_bag_backward_occupancy(int grad_bf16, int vec,
                                                int passes,
                                                int* blocks_per_sm) {
  return dispatch(grad_bf16, vec, passes, [&](auto l) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, decltype(l)::kernel(), kWarps * 32, 0);
  });
}

// keys int32 [slots] ascending (ids, `vocab` for an id outside the table),
// order int64 [slots] (the slot of each key, stable), mask f32 [slots] or
// null, grad_out [slots / bag, d] (bf16 if grad_bf16, else f32), aligned to
// vec of its elements, starts int32 [ceil(vocab / rows_per_tile) + 1]
// (scratch) -> grad_table f32 [vocab, d], 16-byte aligned, every element
// written.  lanes_per_row a power of two up to 32 with passes * lanes_per_row
// * vec covering d (or all 32 lanes, in column blocks), rows_per_tile at most
// 1,024; blocks of 256 threads.
extern "C" int embedding_bag_backward_launch(
    const void* keys, const void* order, const void* mask,
    const void* grad_out, int slots, int bag, int vocab, int d,
    int round_bf16, int grad_bf16, int vec, int lanes_per_row, int passes,
    int rows_per_tile, int blocks, void* starts, void* grad_table,
    void* stream) {
  if (vocab <= 0 || d <= 0) return 0;
  const int lanes_log2 = log2_exact(lanes_per_row);
  if (slots < 0 || bag < 1 || blocks < 1 || lanes_log2 < 0 ||
      lanes_log2 > 5 || vec < 1 || d % vec != 0 || rows_per_tile < 1 ||
      rows_per_tile > kMaxTileRows || slots % bag != 0 ||
      (lanes_per_row < 32 && passes * lanes_per_row * vec < d))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((long long)vocab + rows_per_tile - 1) /
                            rows_per_tile);
  cudaStream_t s = (cudaStream_t)stream;
  const int* k = (const int*)keys;
  embedding_bag_backward_starts<<<n_tiles / kStartThreads + 1, kStartThreads,
                                  0, s>>>(k, slots, vocab, rows_per_tile,
                                          n_tiles, (int*)starts);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return dispatch(grad_bf16, vec, passes, [&](auto l) {
    decltype(l)::launch(k, (const long long*)order, (const float*)mask,
                        grad_out, (const int*)starts, bag, vocab, d,
                        rows_per_tile, n_tiles, lanes_log2, round_bf16,
                        blocks, (float*)grad_table, s);
    return (int)cudaGetLastError();
  });
}
