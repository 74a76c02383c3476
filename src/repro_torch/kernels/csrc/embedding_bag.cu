// embedding_bag: the bag-sum lookup of the recsys embedding tables.
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag.py:40, body `_embedding_bag_kernel` :27):
//
//   out[r, :] = sum_i mask[r, i] * round(table[ids[r, i], :])
//
// with `round` the identity or a round to bf16 (the compute dtype the
// reference casts its table to before the take), the products and the sum
// in f32 in bag order, and the result stored as f32 or bf16.  A null mask
// is a weight of one on every slot: the row is added as it is (1 * x == x
// bit for bit).  An id in [-V, 0) counts from the end of the table and any
// other id outside [0, V) gives a NaN row, as `jnp.take` does; the table
// is never read there.
//
// Bound: bytes.  Each distinct row is read once (D * 4 B), ids once (4 B a
// slot) and the mask, if any, once (4 B a slot), and the output written
// once; the multiply-adds are far below the card's f32 rate.  The TPU
// kernel pins a model shard's table in VMEM; here the table (26 million
// rows at full width, 6.66 GB) stays in device memory and is only
// gathered, with no reuse, so what sets the rate is the number of bytes in
// flight.  Design:
//
// - Persistent warps.  The grid is the card's resident blocks (the wrapper
//   sizes it once from the occupancy and the SM count); each warp walks
//   chunks of `chunk` consecutive output rows (32, fewer on a small launch
//   so that every SM gets work) with a grid stride.  One-slot bags (DLRM's
//   `lookup`, with no mask) have a kernel of their own: a chunk's ids and
//   weights arrive in one coalesced load, one a lane; the next chunk's are
//   loaded while this chunk's gathers are in flight, and lanes share ids
//   with __shfl_sync; with no mask it reads and shuffles no weight.
// - Many gathers in flight.  LPR lanes cover a row with V-wide loads (at
//   D = 16, 32, 64: D / 4 lanes of float4, so one warp instruction loads
//   32 / LPR rows; otherwise all 32 lanes across one row, in passes of
//   32 * V columns).  Each lane issues kLoads independent row loads before
//   any arithmetic or store: at D = 64, 8 float4 loads a lane, 16 rows and
//   4 KB a warp.  Multi-slot bags walk the bag in order for kLoads rows at
//   a time, the next slot's ids loaded while this slot's rows land.
// - Streaming stores.  The output (3.3 GB at DLRM's retrieval shape) is
//   written with __stcs (evict-first), so it passes through L2 without
//   evicting the table's hot rows.
//
// Every offset is 64-bit: id * D reaches 1.66e9 elements and its byte
// offset passes 2**31.  Sums use __fmul_rn / __fadd_rn in bag order, so
// nothing is contracted into an fma and the plain version (the same loop
// in PyTorch) is reproduced bit for bit.  No atomics: every output element
// is written by one lane, so two launches give the same bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // warps a block
constexpr int kMaxChunk = 32;  // rows a chunk: one id (and weight) a lane
constexpr int kLoads = 8;      // independent row loads a lane keeps in flight
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned pack(float a, float b) {
  return (unsigned)bf16_bits(a) | ((unsigned)bf16_bits(b) << 16);
}

// evict-first stores of V values
__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  __stcs(p, v[0]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  __stcs(reinterpret_cast<unsigned short*>(p), bf16_bits(v[0]));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  __stcs(reinterpret_cast<unsigned*>(p), pack(v[0], v[1]));
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(pack(v[0], v[1]), pack(v[2], v[3])));
}

template <bool kRoundBf16>
__device__ __forceinline__ float rounded(float x) {
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// The element offset of row `id` of the table, or -1 outside [-V, V).
__device__ __forceinline__ long long row_offset(long long id, long long vocab,
                                                int d) {
  if (id < 0) id += vocab;
  return id >= 0 && id < vocab ? id * d : -1;
}

template <int V>
__device__ __forceinline__ void gather(const float* __restrict__ table,
                                       long long off, int c, float (&v)[V]) {
  if (off >= 0) {
    load(table + off + c, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __int_as_float(0x7fc00000);
  }
}

// Both kernels: one warp per chunk of `chunk` rows, grid-stride over the
// chunks.  Lane `lane` serves rows `k * (32 / LPR) + lane / LPR` of each
// chunk, k < chunk * LPR / 32, and columns `(lane % LPR) * V` plus
// multiples of `LPR * V`.

// One-slot bags (`lookup`): the chunk's ids (and weights, kMask) one a
// lane, the next chunk's loaded while this chunk's rows are gathered.  At
// most 80 registers a thread, so three blocks (24 warps) fit an SM: on the
// card, a cap of 64 (four blocks) spilled and lost a quarter of the rate,
// and 16 loads a lane at two blocks lost 7% at DLRM's retrieval shape.
template <int V, int LPR, bool kRoundBf16, typename Out, bool kMask>
__global__ void __launch_bounds__(kWarps * 32, 3)
embedding_bag_one_hot(const int* __restrict__ ids,
                      const float* __restrict__ mask,
                      const float* __restrict__ table, long long rows,
                      long long vocab, int d, int chunk,
                      Out* __restrict__ out) {
  constexpr int kRpi = 32 / LPR;  // rows one warp instruction covers
  const int lane = threadIdx.x & 31;
  const int slot = lane / LPR;
  const int col0 = (lane % LPR) * V;
  const int per_lane = chunk / kRpi;  // rows a lane serves in a chunk
  const long long warps = (long long)gridDim.x * kWarps;
  const long long n_chunks = (rows + chunk - 1) / chunk;
  long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);

  // this lane's id and weight in chunk c, loaded one chunk ahead
  int next_id = 0;
  float next_w = 1.0f;
  auto fetch = [&](long long cc) {
    const long long r = cc * chunk + lane;
    if (cc < n_chunks && lane < chunk && r < rows) {
      next_id = __ldg(ids + r);
      if (kMask) next_w = __ldg(mask + r);
    }
  };
  fetch(c);
  for (; c < n_chunks; c += warps) {
    const int my_id = next_id;
    const float my_w = next_w;
    fetch(c + warps);
    const long long base = c * chunk;
    for (int k0 = 0; k0 < per_lane; k0 += kLoads) {
      // every lane shuffles, before lanes past the row's width drop out
      long long off[kLoads];
      float w[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int src = ((k0 + u) * kRpi + slot) & (kMaxChunk - 1);
        off[u] = row_offset(__shfl_sync(kAll, my_id, src), vocab, d);
        w[u] = kMask ? __shfl_sync(kAll, my_w, src) : 1.0f;
      }
      for (int cc = col0; cc < d; cc += LPR * V) {
        float v[kLoads][V];
        // a row past the end of the last chunk gathers a stale in-range
        // id (or none) and is never stored
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (k0 + u < per_lane) gather<V>(table, off[u], cc, v[u]);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int j = (k0 + u) * kRpi + slot;
          if (k0 + u >= per_lane || base + j >= rows) continue;
          float o[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float x = rounded<kRoundBf16>(v[u][k]);
            o[k] = kMask ? __fmul_rn(w[u], x) : x;
          }
          store(out + (base + j) * d + cc, o);
        }
      }
    }
  }
}

// Multi-slot bags (`bag_lookup`): kLoads rows a lane at a time walk the bag
// in order, the next slot's ids and weights loaded while this slot's rows
// land.
template <int V, int LPR, bool kRoundBf16, typename Out>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_multi(const int* __restrict__ ids, const float* __restrict__ mask,
           const float* __restrict__ table, long long rows, int bag,
           long long vocab, int d, int chunk, Out* __restrict__ out) {
  constexpr int kRpi = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int slot = lane / LPR;
  const int col0 = (lane % LPR) * V;
  const int per_lane = chunk / kRpi;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long n_chunks = (rows + chunk - 1) / chunk;
  for (long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       c < n_chunks; c += warps) {
    const long long base = c * chunk;
    for (int k0 = 0; k0 < per_lane; k0 += kLoads) {
      long long r[kLoads];
      bool live[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        r[u] = base + (k0 + u) * kRpi + slot;
        live[u] = k0 + u < per_lane && r[u] < rows;
      }
      for (int cc = col0; cc < d; cc += LPR * V) {
        float acc[kLoads][V];
        int id[kLoads];
        float w[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          id[u] = live[u] ? __ldg(ids + r[u] * bag) : 0;
          w[u] = live[u] && mask ? __ldg(mask + r[u] * bag) : 1.0f;
        }
        for (int i = 0; i < bag; ++i) {
          float v[kLoads][V];
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            if (live[u])
              gather<V>(table, row_offset(id[u], vocab, d), cc, v[u]);
          int next_id[kLoads];
          float next_w[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const bool more = live[u] && i + 1 < bag;
            next_id[u] = more ? __ldg(ids + r[u] * bag + i + 1) : 0;
            next_w[u] = more && mask ? __ldg(mask + r[u] * bag + i + 1) : 1.0f;
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float x = rounded<kRoundBf16>(v[u][k]);
              const float p = mask ? __fmul_rn(w[u], x) : x;
              acc[u][k] = i == 0 ? p : __fadd_rn(acc[u][k], p);
            }
            id[u] = next_id[u];
            w[u] = next_w[u];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (live[u]) store(out + r[u] * d + cc, acc[u]);
      }
    }
  }
}

template <int V, int LPR, bool kRoundBf16, typename Out>
struct Launcher {
  static int occupancy(bool one_hot, bool masked, int* blocks_per_sm) {
    const void* fn =
        !one_hot ? (const void*)embedding_bag_multi<V, LPR, kRoundBf16, Out>
        : masked ? (const void*)embedding_bag_one_hot<V, LPR, kRoundBf16, Out,
                                                      true>
                 : (const void*)embedding_bag_one_hot<V, LPR, kRoundBf16, Out,
                                                      false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, kWarps * 32, 0);
  }
  static int launch(const void* ids, const void* mask, const void* table,
                    long long rows, int bag, long long vocab, int d,
                    int chunk, int blocks, void* out, cudaStream_t s) {
    const int* i = (const int*)ids;
    const float* m = (const float*)mask;
    const float* t = (const float*)table;
    if (bag == 1 && m)
      embedding_bag_one_hot<V, LPR, kRoundBf16, Out, true>
          <<<blocks, kWarps * 32, 0, s>>>(i, m, t, rows, vocab, d, chunk,
                                          (Out*)out);
    else if (bag == 1)
      embedding_bag_one_hot<V, LPR, kRoundBf16, Out, false>
          <<<blocks, kWarps * 32, 0, s>>>(i, nullptr, t, rows, vocab, d,
                                          chunk, (Out*)out);
    else
      embedding_bag_multi<V, LPR, kRoundBf16, Out>
          <<<blocks, kWarps * 32, 0, s>>>(i, m, t, rows, bag, vocab, d, chunk,
                                          (Out*)out);
    return (int)cudaGetLastError();
  }
};

// Calls fn(Launcher<...>()) for the runtime variant, or returns
// cudaErrorInvalidValue for one that is not compiled.
template <int V, int LPR, typename Fn>
int by_dtype(int round_bf16, int out_bf16, Fn fn) {
  if (round_bf16 && out_bf16)
    return fn(Launcher<V, LPR, true, __nv_bfloat16>());
  if (round_bf16) return fn(Launcher<V, LPR, true, float>());
  if (out_bf16) return fn(Launcher<V, LPR, false, __nv_bfloat16>());
  return fn(Launcher<V, LPR, false, float>());
}

template <typename Fn>
int dispatch(int v, int lpr, int round_bf16, int out_bf16, Fn fn) {
  if (v == 4 && lpr == 4) return by_dtype<4, 4>(round_bf16, out_bf16, fn);
  if (v == 4 && lpr == 8) return by_dtype<4, 8>(round_bf16, out_bf16, fn);
  if (v == 4 && lpr == 16) return by_dtype<4, 16>(round_bf16, out_bf16, fn);
  if (v == 4 && lpr == 32) return by_dtype<4, 32>(round_bf16, out_bf16, fn);
  if (v == 2 && lpr == 32) return by_dtype<2, 32>(round_bf16, out_bf16, fn);
  if (v == 1 && lpr == 32) return by_dtype<1, 32>(round_bf16, out_bf16, fn);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Resident blocks an SM of the current device holds for one variant
// (one-slot bags or not, a mask or not, vec, lanes a row, dtypes): the
// wrapper sizes the persistent grid from it.
extern "C" int embedding_bag_occupancy(int one_hot, int masked, int vec,
                                       int lanes_per_row, int round_bf16,
                                       int out_bf16, int* blocks_per_sm) {
  return dispatch(vec, lanes_per_row, round_bf16, out_bf16, [&](auto l) {
    return decltype(l)::occupancy(one_hot != 0, masked != 0, blocks_per_sm);
  });
}

// ids int32 [rows, bag], mask f32 [rows, bag] or null (weight one), table
// f32 [vocab, d] -> out [rows, d] (bf16 if out_bf16, else f32).  vec (1, 2
// or 4) values a load and store, lanes_per_row lanes a row (32, or d / 4
// with vec 4), chunk rows a chunk (a power of two with 32 / lanes_per_row
// <= chunk <= 32), blocks of 256 threads.  Table and out aligned to vec * 4
// bytes, bag >= 1.
extern "C" int embedding_bag_launch(const void* ids, const void* mask,
                                    const void* table, long long rows,
                                    int bag, long long vocab, int d,
                                    int round_bf16, int out_bf16, int vec,
                                    int lanes_per_row, int chunk, int blocks,
                                    void* out, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const bool packed = lanes_per_row < 32;
  if (bag < 1 || vocab < 1 || blocks < 1 || d % vec != 0
      || (packed && (vec != 4 || lanes_per_row * vec != d))
      || chunk > kMaxChunk || chunk * lanes_per_row < 32
      || (chunk & (chunk - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(vec, lanes_per_row, round_bf16, out_bf16, [&](auto l) {
    return decltype(l)::launch(ids, mask, table, rows, bag, vocab, d, chunk,
                               blocks, out, s);
  });
}
